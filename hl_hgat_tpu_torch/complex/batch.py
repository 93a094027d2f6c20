"""Flat (COO/ELL) batch layout (``hl_hgat_tpu/complex/batch.py``).

A batch is the block-diagonal concatenation of its graphs, padded to fixed
sizes with validity masks; graph membership and pooling assignments are
precomputed id arrays whose padding points at a dump bucket one past the
last valid id.  The fields hold NumPy arrays as ``collate`` builds them and
tensors after ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from hl_hgat_tpu_torch.utils import profiling


def _to(v, device):
    """``v`` as a tensor on ``device``; with the port's tracing on, the
    bytes that leave the host for a card count under ``h2d_bytes``
    (``utils/profiling.py``; the tensor's size, no sync)."""
    if v is None:
        return None
    t = torch.as_tensor(v)
    if profiling.tracing and t.device.type == "cpu" and torch.device(device).type != "cpu":
        profiling.count("h2d_bytes", t.nbytes)
    return t.to(device)


def _fields_to(obj, device, keep: tuple[str, ...]):
    """``obj`` with every field but ``keep`` as a tensor on ``device``."""
    moved = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in keep:
            continue
        moved[f.name] = v.to(device) if isinstance(v, CooMatrix) else _to(v, device)
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Padded COO sparse matrix; padding entries must have ``vals == 0``.

    ``ell_cols``/``ell_vals`` optionally carry the same pattern packed in ELL
    [rows, width] form (``collate(..., with_ell=True)``), the input of the
    row-gather SpMM kernel (``ops/ell_spmm.py``).  ``symmetric`` marks
    operators equal to their transpose (L0 and L1 are), which lets the ELL
    path serve its own backward pass.
    """

    rows: Any  # [nnz] int32
    cols: Any  # [nnz] int32
    vals: Any  # [nnz] float32
    shape: tuple[int, int]  # logical (padded) shape
    ell_cols: Any | None = None  # [num_rows, width] int32
    ell_vals: Any | None = None  # [num_rows, width] float32
    symmetric: bool = False

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def to(self, device) -> "CooMatrix":
        return _fields_to(self, device, keep=("shape", "symmetric"))


@dataclasses.dataclass(frozen=True)
class ComplexLevel:
    """Structure of one resolution level: the boundary operator as src/dst
    endpoint lists (B1 has two entries per column, ``ops/boundary.py``), the
    Hodge Laplacians, masks, graph-membership ids and node degrees."""

    src: Any  # [E] int32, canonical src < dst
    dst: Any  # [E] int32
    node_mask: Any  # [N] float32, 1 for real nodes
    edge_mask: Any  # [E] float32
    n_id: Any  # [N] int32 graph id per node; padding points at num_graphs
    s_id: Any  # [E] int32 graph id per edge
    l0: CooMatrix  # node Hodge Laplacian, spectrum in [0, 2]
    l1: CooMatrix  # edge Hodge Laplacian
    deg: Any  # [N] float32 node degree (no epsilon; models add their own)
    num_graphs: int

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    def to(self, device) -> "ComplexLevel":
        return _fields_to(self, device, keep=("num_graphs",))


@dataclasses.dataclass(frozen=True)
class PoolMap:
    """Fine→coarse assignment of a coarsening step: ``pos_t[n]`` is the
    batched coarse node id of fine node ``n``, ``pos_s[e]`` the coarse edge
    id; dropped nodes, intra-cluster and padded edges point at the dump slot
    one past the last coarse id."""

    pos_t: Any  # [N_fine] int32 in [0, N_coarse]
    pos_s: Any  # [E_fine] int32 in [0, E_coarse]

    def to(self, device) -> "PoolMap":
        return _fields_to(self, device, keep=())


@dataclasses.dataclass(frozen=True)
class ComplexBatch:
    """A padded batch of simplex graphs.  ``y`` is per graph, per node or
    per edge as the collate was asked; for link prediction ``pairs`` [P, 2]
    holds global node-row ids in contiguous groups of (one positive, then
    its negatives), ``y`` the [P] pair labels and ``pair_mask`` kills padded
    rows."""

    x_t: Any  # [N, Ft]
    x_s: Any  # [E, Fs]
    y: Any
    levels: tuple[ComplexLevel, ...]
    pools: tuple[PoolMap, ...]
    num_graphs: int
    pairs: Any | None = None
    pair_mask: Any | None = None

    @property
    def level0(self) -> ComplexLevel:
        return self.levels[0]

    def replace(self, **kw: Any) -> "ComplexBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ComplexBatch":
        """Every array as a tensor on ``device``."""
        return ComplexBatch(
            x_t=_to(self.x_t, device),
            x_s=_to(self.x_s, device),
            y=_to(self.y, device),
            levels=tuple(lvl.to(device) for lvl in self.levels),
            pools=tuple(p.to(device) for p in self.pools),
            num_graphs=self.num_graphs,
            pairs=_to(self.pairs, device),
            pair_mask=_to(self.pair_mask, device),
        )


def graph_sizes(level: ComplexLevel) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-graph (num_nodes, num_edges) recovered from masks + segment ids."""
    from hl_hgat_tpu_torch.ops.segment import segment_sum

    t = torch.as_tensor
    return (
        segment_sum(t(level.node_mask), t(level.n_id), level.num_graphs),
        segment_sum(t(level.edge_mask), t(level.s_id), level.num_graphs),
    )
