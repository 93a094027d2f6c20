"""Analysis and observability (``hl_hgat_tpu/utils``): the arrays behind
the figures, step timing and tracing, and the reference state-dict
importers."""

from hl_hgat_tpu_torch.utils.profiling import StepTimer, trace_context
from hl_hgat_tpu_torch.utils.torch_import import (
    import_hgat_attpool,
    infer_hgat_config,
    load_torch_state_dict,
)
from hl_hgat_tpu_torch.utils.viz import (
    attention_fc_matrix,
    collect_outputs,
    edge_index_from_level,
    feature_trends,
    sort_by_parcels,
)

__all__ = [
    "import_hgat_attpool",
    "infer_hgat_config",
    "load_torch_state_dict",
    "collect_outputs",
    "feature_trends",
    "attention_fc_matrix",
    "sort_by_parcels",
    "edge_index_from_level",
    "StepTimer",
    "trace_context",
]
