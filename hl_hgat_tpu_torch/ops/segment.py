"""Segment means and the embedding lookup (``hl_hgat_tpu/ops/segment.py``).

Accumulation is float32 whatever the data dtype; the total is cast to the
data dtype before the division, as in the JAX package, so the bf16 result
differs from a float32 one by the rounding of one division.
"""

from __future__ import annotations

import torch


def segment_mean_onehot(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted per-segment mean of ``data`` rows as a one-hot matmul —
    for small ``rows × num_segments`` (graph readouts).  Ids at or beyond
    ``num_segments`` (the padding dump bucket) match no row of the one-hot
    matrix and drop out."""
    onehot = segment_ids[None, :] == torch.arange(
        num_segments, dtype=segment_ids.dtype, device=segment_ids.device
    )[:, None]
    w32 = onehot.float()
    if weights is not None:
        w32 = w32 * weights.float()[None, :]
    count = w32.sum(dim=1)
    # one-hot and 0/1 weights are exact in bf16, so rounding the matrix to
    # a bf16 operand's dtype (as the JAX package does) changes nothing
    total = torch.matmul(w32, data.float()).to(data.dtype)
    return total / count.clamp(min=1.0)[:, None].to(total.dtype)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted per-segment mean by scatter-add (``index_add_``); rows whose
    id is at or beyond ``num_segments`` are dropped; empty segments give 0."""
    shape = (-1,) + (1,) * (data.ndim - 1)
    if weights is not None:
        data = data * weights.reshape(shape).to(data.dtype)
    keep = segment_ids < num_segments
    ids = segment_ids[keep]
    total = torch.zeros(
        (num_segments,) + data.shape[1:], dtype=torch.float32, device=data.device
    ).index_add_(0, ids, data[keep].float()).to(data.dtype)
    w = (
        torch.ones(ids.shape, dtype=torch.float32, device=data.device)
        if weights is None
        else weights[keep].float()
    )
    count = torch.zeros(num_segments, dtype=torch.float32, device=data.device)
    count.index_add_(0, ids, w)
    return total / count.clamp(min=1.0).reshape(shape).to(total.dtype)


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        onehot = flat[:, None] == torch.arange(
            ctx.rows, dtype=flat.dtype, device=flat.device)[None, :]
        dtable = torch.matmul(onehot.float().t(), g.reshape(flat.shape[0], -1).float())
        return dtable.to(g.dtype), None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` whose backward is the float32 one-hot matmul
    ``dTable = onehotᵀ @ g`` (the JAX ``embed_lookup``), not a scatter-add:
    the vocabulary is tiny, and the matmul sums in a fixed order where
    atomics on the card would not."""
    return _EmbedLookup.apply(table, ids)
