"""Reference-model presets (``hl_hgat_tpu/models/presets.py``)."""

from __future__ import annotations

import torch

from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.models.backbone import (
    BackboneConfig,
    HLHGCNNGraph,
    HLHGCNNLinkPred,
    HLHGCNNNode,
)


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


PRESETS = {
    "zinc_pyr": zinc_pyr,
    "pascalvoc_node": pascalvoc_node,
    "coco_node": coco_node,
    "pcqm_link": pcqm_link,
}
