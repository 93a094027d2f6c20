"""On-device TSP structure augmentation (``hl_hgat_tpu/complex/augment.py::
tsp_dropout_device``).

Reference semantics (lib/Hodge_Dataset.py:690-708 and dropout_node
:142-166): per graph, with probability ``apply_prob`` draw a rate
p′ ~ U[0, 0.5) and drop each edge-simplex with probability p′ unless its
label is positive (tour edges are protected).  The dropped simplices leave
**L1 only** (the induced subgraph of the edge graph), and the keep mask
replaces x_s's last column, which the TSP model multiplies into its
logits; L0, B1, degrees and features are untouched.  At fixed shapes the
induced subgraph is L1's values times keep[row]·keep[col].

``tsp_keep`` draws the keep mask, ``apply_tsp_keep`` applies a given one
(either layout: a flat `ComplexBatch`, COO and ELL values; a packed
`DenseBatch`, dense blocks, both bands with the column block's keep, and
the spill), and ``tsp_dropout`` does both.  The random stream is torch's,
not the JAX package's.
"""

from __future__ import annotations

import dataclasses

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
