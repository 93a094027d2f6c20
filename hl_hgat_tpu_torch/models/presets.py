"""Reference-model presets (``hl_hgat_tpu/models/presets.py``)."""

from __future__ import annotations

import torch

from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.models.abcd import HLHGCNNAbcd
from hl_hgat_tpu_torch.models.backbone import (
    BackboneConfig,
    HLHGCNNGraph,
    HLHGCNNLinkPred,
    HLHGCNNNode,
    HLHGCNNTsp,
)
from hl_hgat_tpu_torch.models.hgat import HLHGATAttpool


def zinc_pyr(
    channels=(2, 3, 3),
    filters=(64, 128, 256),
    k=6,
    keig=15,
    dropout=0.0,
    mlp_channels=(256, 256),
    use_embedding=True,
    compute_dtype="float32",
    *,
    in_t: int | None = None,
    in_s: int | None = None,
    seed: int = 0,
    device=None,
):
    """ZINC script variant: shared nn.Embedding(28) inputs, init conv K=1,
    no degree epsilon (reference main_zinc...py:52-53,58,127).

    ``in_t``/``in_s`` default to an id column plus ``keig`` PE columns (the
    layout of ``data/synthetic.zinc_like_samples``).  Weights come from a
    ``torch.Generator`` seeded with ``seed``; the model is returned on
    ``device`` (the CUDA card unless ``device="cpu"``).
    """
    device = resolve_device(device)
    cfg = BackboneConfig(
        channels=tuple(channels),
        filters=tuple(filters),
        k=k,
        init_k=1 if use_embedding else k,
        dropout=dropout,
        deg_eps=0.0,  # reference quirk (lib/Hodge_ST_Model.py:624)
        compute_dtype=compute_dtype,
    )
    width = 1 + keig
    model = HLHGCNNGraph(
        cfg,
        in_t if in_t is not None else width,
        in_s if in_s is not None else width,
        mlp_channels=tuple(mlp_channels),
        num_classes=1,
        embed_num=28 if use_embedding else 0,
        embed_dim=(filters[0] - keig) if use_embedding else 0,
        generator=torch.Generator().manual_seed(seed),
    )
    return model.to(device), dict(task="regression", y_mean=0.0153, y_std=2.0109)


def _graph_model(cfg, in_t, in_s, mlp_channels, num_classes, seed, device, meta,
                 dropout_mlp=0.0):
    model = HLHGCNNGraph(
        cfg, in_t, in_s, mlp_channels=tuple(mlp_channels), num_classes=num_classes,
        dropout_mlp=dropout_mlp, generator=torch.Generator().manual_seed(seed),
    )
    return model.to(resolve_device(device)), meta


# The pooled and gated family.  Input widths default to feature columns plus
# keig − 1 PE columns: ZINC's 21 atom and 3 bond columns, the superpixel
# and peptide samples' 9 and 3 (``data/synthetic.pooled_like_samples``).
# Pooled models read a batch whose samples carry one coarsened level per
# entry of ``pool_locs`` (``num_pool=1``).

_ZINC_META = dict(task="regression", y_mean=0.0153, y_std=2.0109)


def zinc_attpool(
    channels=(2, 2, 2, 2), filters=(64, 128, 256, 512), k=2, keig=7,
    dropout=0.0, mlp_channels=(), compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """reference lib/Hodge_ST_Model.py:412-541: ReLU gates computed from and
    applied to the last layer outputs, while the pool moves the stacks (a
    faithful quirk, reference :517-521)."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k,
        dropout=dropout, deg_eps=0.0, pool_locs=(0,), att_sigma="relu",
        gate_input="last", gate_target="last", stack_concat="layer",
        compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 20 + keig, in_s or 2 + keig, mlp_channels, 1, seed,
                        device, dict(_ZINC_META))


def zinc_poolint3_pyr(
    channels=(2, 2, 2, 2), filters=(64, 128, 256, 512), k=2, keig=7, dropout=0.0,
    mlp_channels=(), compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """reference lib/Hodge_ST_Model.py:649-749: one MSI per block after the
    convs, which read the raw stacks."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k,
        dropout=dropout, deg_eps=0.0, msi_per_layer=False, stack_concat="layer",
        compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 20 + keig, in_s or 2 + keig, mlp_channels, 1, seed,
                        device, dict(_ZINC_META))


def pepfunc_attpool(
    channels=(2, 2, 2), filters=(64, 128, 256), k=6, keig=10, dropout=0.25,
    mlp_channels=(256,), pool_loc=1, script_variant=True, compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """10-way multilabel.  The script variant gates the stacks after every
    block with λ = 0.5 and pools at ``pool_loc`` (reference
    main_pepfunc...py:90,133-149); the lib variant gates only at
    ``pool_loc`` with λ = 0.9 (reference lib/Hodge_ST_Model.py:225-227)."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=1,
        dropout=dropout, deg_eps=1e-6, pool_locs=(pool_loc,),
        att_locs=tuple(range(len(channels))) if script_variant else (),
        att_sigma="sigmoid", att_lam=0.5 if script_variant else 0.9,
        gate_input="stack", gate_target="stack", stack_concat="layer",
        compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 8 + keig, in_s or 2 + keig, mlp_channels, 10, seed,
                        device, dict(task="multilabel"))


def pepfunc_pyr(
    channels=(2, 2, 2, 2), filters=(64, 128, 256, 512), k=2, keig=10, dropout=0.0,
    mlp_channels=(), compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """reference lib/Hodge_ST_Model.py:307-407: no pooling, init conv K=K."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k,
        dropout=dropout, deg_eps=1e-6, compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 8 + keig, in_s or 2 + keig, mlp_channels, 10, seed,
                        device, dict(task="multilabel"))


def cifar10sp_pyr(
    channels=(2, 2, 2, 2), filters=(64, 128, 256, 512), k=2, keig=10,
    dropout=0.0, mlp_channels=(), lam=0.9, compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """reference lib/Hodge_ST_Model.py:858-1091 without pooling."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=1,
        dropout=dropout, deg_eps=1e-6, att_lam=lam, compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 8 + keig, in_s or 2 + keig, mlp_channels, 10, seed,
                        device, dict(task="classification"))


def cifar10sp_attpool(
    channels=(2, 2, 2), filters=(64, 128, 256), k=4, keig=10, dropout=0.25,
    mlp_channels=(256,), lam=0.5, compute_dtype="float32",
    *, in_t: int | None = None, in_s: int | None = None, seed: int = 0, device=None,
):
    """ReLU gates, max-normalized, applied to the last outputs (reference
    lib/Hodge_ST_Model.py:1058-1064); λ = 0.5."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=1,
        dropout=dropout, deg_eps=1e-6, pool_locs=(0,), att_sigma="relu", att_lam=lam,
        gate_input="last", gate_target="last", max_normalize_gates=True,
        stack_concat="layer", compute_dtype=compute_dtype,
    )
    return _graph_model(cfg, in_t or 8 + keig, in_s or 2 + keig, mlp_channels, 10, seed,
                        device, dict(task="classification"))


# LRGB extensions of the JAX package: PascalVOC-SP / COCO-SP node
# classification and PCQM-Contact link prediction (flat layout).


def _lrgb_cfg(channels, filters, k, dropout, compute_dtype) -> BackboneConfig:
    return BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=1,
        dropout=dropout, deg_eps=1e-6, compute_dtype=compute_dtype,
    )


def pascalvoc_node(
    channels=(2, 2, 2), filters=(64, 128, 256), k=4, dropout=0.1,
    mlp_channels=(128,), num_classes=21, compute_dtype="float32",
    *, in_t: int = 14, in_s: int = 2, seed: int = 0, device=None,
):
    """Per-node classifier; ``in_t``/``in_s`` default to PascalVOC-SP's 14
    node and 2 edge features."""
    device = resolve_device(device)
    model = HLHGCNNNode(
        _lrgb_cfg(channels, filters, k, dropout, compute_dtype), in_t, in_s,
        mlp_channels=tuple(mlp_channels), num_classes=num_classes,
        generator=torch.Generator().manual_seed(seed),
    )
    return model.to(device), dict(task="node_classification")


def coco_node(**kw):
    kw.setdefault("num_classes", 81)
    return pascalvoc_node(**kw)


def pcqm_link(
    channels=(2, 2, 2), filters=(64, 128, 256), k=4, dropout=0.1,
    mlp_channels=(128,), compute_dtype="float32",
    *, in_t: int = 9, in_s: int = 3, seed: int = 0, device=None,
):
    """Pair scorer for PCQM-Contact: the query pairs ride the batch
    (``ComplexBatch.pairs``/``pair_mask`` and per-pair ``y``), so the
    ``Trainer`` loop applies; ``in_t``/``in_s`` default to the dataset's 9
    atom and 3 bond features."""
    device = resolve_device(device)
    model = HLHGCNNLinkPred(
        _lrgb_cfg(channels, filters, k, dropout, compute_dtype), in_t, in_s,
        mlp_channels=tuple(mlp_channels),
        generator=torch.Generator().manual_seed(seed),
    )
    return model.to(device), dict(task="link_prediction")


def tsp_pyr(
    channels=(4, 4, 4), filters=(32, 64, 128), k=4, dropout=0.25,
    mlp_channels=(256,), compute_dtype="float32",
    *, in_t: int = 2, in_s: int = 2, seed: int = 0, device=None,
):
    """Edge-level TSP model (reference lib/Hodge_ST_Model.py:756-852,
    main_TSP...py): x_t the 2-D coordinates, x_s an edge weight plus the
    augmentation-mask column (``data/synthetic.tsp_like_samples``)."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k,
        act="relu", dropout=dropout, deg_eps=1e-6, compute_dtype=compute_dtype,
    )
    device = resolve_device(device)
    model = HLHGCNNTsp(cfg, in_t, in_s, mlp_channels=tuple(mlp_channels),
                       generator=torch.Generator().manual_seed(seed))
    return model.to(device), dict(task="edge_binary")


# The brain family (reference lib/Hodge_ST_Model.py:26-168; HL-HGAT-DEMO/
# lib/Hodge_Cheb_Conv.py:250-399).  The node input is each ROI's time
# course (Inception1D embeds it), the edge input one FC value; the
# ``*_per_graph`` counts are the final level's (the fine level's for the
# attention maps) of the shared pyramid, as ``data/brain.py`` builds it.
_BRAIN_META = dict(task="regression", y_mean=95.1377, y_std=7.3)


def abcd_attpool(
    channels=(2, 2, 2), filters=(64, 128, 256), k=2, dropout=0.0, mlp_channels=(),
    nodes_per_graph=0, edges_per_graph=0, pool_num=1, compute_dtype="float32",
    *, in_s: int = 1, seed: int = 0, device=None,
):
    """``pool_num`` mirrors the reference ctor's ``pool_loc`` list
    (lib/Hodge_ST_Model.py:28): pools after blocks 0 .. pool_num − 1, which
    must not include the last block (its pool would only move the dead
    stack)."""
    if pool_num >= len(channels):
        raise ValueError(
            f"pool_num {pool_num} needs non-final pools; model has {len(channels)} blocks")
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k, act="leaky_relu",
        dropout=dropout, deg_eps=1e-6, pool_locs=tuple(range(pool_num)),
        att_sigma="sigmoid", gate_input="last", gate_target="stack", stack_concat="layer",
        compute_dtype=compute_dtype,
    )
    device = resolve_device(device)
    model = HLHGCNNAbcd(cfg, in_s, mlp_channels=tuple(mlp_channels),
                        nodes_per_graph=nodes_per_graph, edges_per_graph=edges_per_graph,
                        generator=torch.Generator().manual_seed(seed))
    return model.to(device), dict(_BRAIN_META)


def hgat_attpool(
    channels=(2, 2, 2), filters=(32, 64, 128), k=4, dropout=0.0, mlp_channels=(),
    pool_num=2, nodes_per_graph=0, edges_per_graph=0, fine_nodes_per_graph=0,
    fine_edges_per_graph=0, demo_conv_compat=False,
    compute_dtype="float32", *, in_s: int = 1, seed: int = 0, device=None,
):
    """``demo_conv_compat=True`` gives the DEMO fast-conv recurrence the
    shipped ``HL_HGAT_Brain.pt`` was trained with
    (HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:561); the default keeps the
    canonical recurrence."""
    cfg = BackboneConfig(
        channels=tuple(channels), filters=tuple(filters), k=k, init_k=k, act="leaky_relu",
        dropout=dropout, deg_eps=1e-6, pool_locs=tuple(range(pool_num)),
        att_sigma="sigmoid", gate_input="stack", gate_target="stack", stack_concat="layer",
        demo_conv_compat=demo_conv_compat, compute_dtype=compute_dtype,
    )
    device = resolve_device(device)
    model = HLHGATAttpool(
        cfg, in_s, mlp_channels=tuple(mlp_channels), nodes_per_graph=nodes_per_graph,
        edges_per_graph=edges_per_graph, fine_nodes_per_graph=fine_nodes_per_graph,
        fine_edges_per_graph=fine_edges_per_graph, generator=torch.Generator().manual_seed(seed))
    return model.to(device), dict(_BRAIN_META)


PRESETS = {
    "zinc_pyr": zinc_pyr,
    "zinc_attpool": zinc_attpool,
    "zinc_poolint3_pyr": zinc_poolint3_pyr,
    "pepfunc_attpool": pepfunc_attpool,
    "pepfunc_pyr": pepfunc_pyr,
    "cifar10sp_pyr": cifar10sp_pyr,
    "cifar10sp_attpool": cifar10sp_attpool,
    "pascalvoc_node": pascalvoc_node,
    "coco_node": coco_node,
    "pcqm_link": pcqm_link,
    "tsp_pyr": tsp_pyr,
    "abcd_attpool": abcd_attpool,
    "hgat_attpool": hgat_attpool,
}
