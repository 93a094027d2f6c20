"""Data augmentations (``hl_hgat_tpu/complex/augment.py``).

Host-side (NumPy) structural augmentations used while building samples:
edge dropout (CIFAR10-SP, reference lib/Hodge_Dataset.py:115-139) and
label-protected node dropout (TSP, reference lib/Hodge_Dataset.py:142-166),
the same ``np.random.Generator`` draws as the JAX package.  On the batch's
device: the eigen-PE sign flip (reference lib/Hodge_Dataset.py:429-439,
per batch instead of per sample) and the TSP structure augmentation.

TSP (``tsp_dropout_device`` there; reference lib/Hodge_Dataset.py:690-708
and dropout_node :142-166): per graph, with probability ``apply_prob`` draw
a rate p′ ~ U[0, 0.5) and drop each edge-simplex with probability p′ unless
its label is positive (tour edges are protected).  The dropped simplices
leave **L1 only** (the induced subgraph of the edge graph), and the keep
mask replaces x_s's last column, which the TSP model multiplies into its
logits; L0, B1, degrees and features are untouched.  At fixed shapes the
induced subgraph is L1's values times keep[row]·keep[col].

``tsp_keep`` draws the keep mask, ``apply_tsp_keep`` applies a given one
(either layout: a flat `ComplexBatch`, COO and ELL values; a packed
`DenseBatch`, dense blocks, both bands with the column block's keep, and
the spill), and ``tsp_dropout`` does both.  The device draws come from a
``torch.Generator``: torch's random stream, not the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.batch import ComplexBatch, CooMatrix
from hl_hgat_tpu_torch.complex.dense import BlockDiagMatrix, shift_blocks


def _edge_gid_and_label(batch):
    """Per edge row: its graph id (padding at ``num_graphs``) and label."""
    level = batch.levels[0]
    if isinstance(batch, ComplexBatch):
        return level.s_id.long(), batch.y.reshape(-1)
    gid = level.s_gid.reshape(-1).long()
    return gid, batch.y.reshape(gid.shape[0], -1)[:, 0]


def tsp_keep(batch, *, apply_prob: float, generator: torch.Generator) -> torch.Tensor:
    """The float32 keep mask [edge rows] of one augmentation draw: per graph
    a Bernoulli(``apply_prob``) and a rate p′ ~ U[0, 0.5), per edge a
    uniform u; an edge is kept if u > p′ of its graph, if its label is
    positive, or if its graph drew no augmentation.  ``generator`` lives
    on the batch's device."""
    gid, y = _edge_gid_and_label(batch)
    ng = batch.num_graphs
    dev = gid.device
    applied = torch.rand(ng + 1, generator=generator, device=dev) < apply_prob
    p_eff = torch.rand(ng + 1, generator=generator, device=dev) * 0.5
    u = torch.rand(gid.shape[0], generator=generator, device=dev)
    gid = gid.clamp(0, ng)
    return ((u > p_eff[gid]) | (y > 0) | ~applied[gid]).float()


def _mask_coo(m: CooMatrix, keep: torch.Tensor) -> CooMatrix:
    k = keep.to(m.vals.dtype)
    ell_vals = m.ell_vals
    if ell_vals is not None:
        ke = keep.to(ell_vals.dtype)
        ell_vals = ell_vals * ke[:, None] * ke[m.ell_cols.long()]
    return dataclasses.replace(m, vals=m.vals * k[m.rows.long()] * k[m.cols.long()],
                               ell_vals=ell_vals)


def _mask_blocks(b, row_keep, col_keep):
    return b * row_keep[:, :, None].to(b.dtype) * col_keep[:, None, :].to(b.dtype)


def apply_tsp_keep(batch, keep: torch.Tensor):
    """``batch`` with L1 restricted to the kept edges (values times
    keep[row]·keep[col]) and x_s's last column set to keep × edge mask."""
    level = batch.levels[0]
    if isinstance(batch, ComplexBatch):
        l1 = _mask_coo(level.l1, keep)
        x_s = batch.x_s.clone()
        x_s[:, -1] = keep * level.edge_mask
    else:
        kb = keep.reshape(level.edge_mask.shape)
        if isinstance(level.l1, BlockDiagMatrix):
            m = level.l1
            # band_up[g]'s columns lie in block g + 1, band_dn[g]'s in g - 1
            up, dn = shift_blocks(kb, 1), shift_blocks(kb, -1)
            l1 = BlockDiagMatrix(
                blocks=_mask_blocks(m.blocks, kb, kb),
                spill=None if m.spill is None else _mask_coo(m.spill, keep),
                band_up=None if m.band_up is None else _mask_blocks(m.band_up, kb, up),
                band_dn=None if m.band_dn is None else _mask_blocks(m.band_dn, kb, dn),
            )
        else:
            l1 = _mask_blocks(level.l1, kb, kb)
        x_s = batch.x_s.clone()
        x_s[..., -1] = kb * level.edge_mask
    new_level = dataclasses.replace(level, l1=l1)
    return batch.replace(x_s=x_s, levels=(new_level,) + tuple(batch.levels[1:]))


def tsp_dropout(batch, *, apply_prob: float = 0.75, generator: torch.Generator):
    """One augmentation draw applied to ``batch`` (tensors on one device)."""
    return apply_tsp_keep(batch, tsp_keep(batch, apply_prob=apply_prob, generator=generator))


def dropout_edge(edge_index: np.ndarray, p: float = 0.5, *,
                 rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random undirected-edge dropout: (kept edge_index, keep mask), the
    reference's semantics (lib/Hodge_Dataset.py:115-139, without
    ``force_undirected``, on the canonical src < dst list)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    if p == 0.0:
        return edge_index, np.ones(edge_index.shape[1], bool)
    mask = rng.random(edge_index.shape[1]) >= p
    return edge_index[:, mask], mask


def dropout_node(edge_index: np.ndarray, edge_attr: np.ndarray, y_loc: np.ndarray,
                 p: float = 0.0, *, num_nodes: int, rng: np.random.Generator):
    """Node dropout that always keeps positively-labelled nodes (the TSP
    augmentation, reference lib/Hodge_Dataset.py:142-166): an effective
    rate p′ = p + U[0, 0.5), each node dropped with probability p′ unless
    ``y_loc`` is set, then the induced subgraph.  Returns (edge_index,
    edge_attr, edge_mask, node_mask)."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    keep_prob = rng.random(num_nodes)
    p_eff = p + rng.random() / 2
    node_mask = (keep_prob > p_eff) | y_loc.astype(bool)
    edge_mask = node_mask[edge_index[0]] & node_mask[edge_index[1]]
    return edge_index[:, edge_mask], edge_attr[edge_mask], edge_mask, node_mask


def pe_sign_flip(x: torch.Tensor, *, num_static: int,
                 generator: torch.Generator) -> torch.Tensor:
    """``x`` with the sign of each eigen-PE column (every column after the
    first ``num_static``) flipped with probability 1/2, one draw a column
    for the whole batch: signs ``(rand(n_pe) < 0.5)·2 − 1`` from
    ``generator``, which lives on ``x``'s device.  Eigenvector signs are
    arbitrary, so a flip per batch on the device is the reference's
    per-sample flip at no host cost."""
    n_pe = x.shape[-1] - num_static
    if n_pe <= 0:
        return x
    signs = (torch.rand(n_pe, generator=generator, device=x.device) < 0.5).to(x.dtype) * 2 - 1
    return x * torch.cat([torch.ones(num_static, dtype=x.dtype, device=x.device), signs])
