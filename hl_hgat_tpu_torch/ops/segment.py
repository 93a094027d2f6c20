"""Segment reductions and the embedding lookup
(``hl_hgat_tpu/ops/segment.py``).

Accumulation is float32 whatever the data dtype; the total is cast to the
data dtype before a division, as in the JAX package, so the bf16 result
differs from a float32 one by the rounding of one division.  Rows whose id
lies outside ``[0, num_segments)`` (the padding dump bucket) are dropped by
every function here, as an XLA scatter drops them.  On a CUDA device the
sums go through ``index_add_`` (atomics): float results may differ in the
last bits from run to run.
"""

from __future__ import annotations

import torch


def _dump_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every id outside ``[0, num_segments)`` sent to the
    extra row ``num_segments``, which the callers cut off: no row is
    filtered by a mask, so nothing waits for the device."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum ``data`` rows [M, ...] into ``num_segments`` buckets; bf16 data
    accumulates in float32 and is rounded once."""
    acc_dtype = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros(
        (num_segments + 1,) + data.shape[1:], dtype=acc_dtype, device=data.device)
    out.index_add_(0, _dump_ids(segment_ids, num_segments), data.to(acc_dtype))
    return out[:num_segments].to(data.dtype)


def segment_count(
    segment_ids: torch.Tensor, num_segments: int, *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Number of (optionally weighted) elements per segment, float32."""
    ones = (
        torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device)
        if weights is None else weights.float()
    )
    return segment_sum(ones, segment_ids, num_segments)


def _segment_amax(x: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max with the dump row kept: [num_segments + 1, ...],
    −inf where a segment is empty."""
    out = torch.full(
        (num_segments + 1,) + x.shape[1:], float("-inf"), dtype=x.dtype, device=x.device)
    index = ids.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    return out.scatter_reduce(0, index, x, reduce="amax", include_self=True)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """Max of ``data`` rows per segment; empty segments yield ``mask_value``."""
    ids = _dump_ids(segment_ids, num_segments)
    out = _segment_amax(data.float(), ids, num_segments)[:num_segments]
    out = torch.where(torch.isneginf(out), torch.full_like(out, mask_value), out)
    return out.to(data.dtype)


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Numerically stable softmax within each segment; ``mask`` (0/1 per
    element) removes padded rows from the max and the normalizer.  Rows of
    the dump bucket come out 0."""
    x = logits.float()
    ids = _dump_ids(segment_ids, num_segments)
    valid = (ids < num_segments).reshape((-1,) + (1,) * (x.ndim - 1))
    if mask is not None:
        valid = valid & mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).bool()
    x = torch.where(valid, x, torch.full_like(x, float("-inf")))
    seg_max = _segment_amax(x, ids, num_segments)
    seg_max = torch.where(torch.isneginf(seg_max), torch.zeros_like(seg_max), seg_max)
    expx = torch.exp(x - seg_max[ids])  # exp(−inf) = 0 on every removed row
    denom = segment_sum(expx, ids, num_segments + 1).clamp(min=1e-16)
    return (expx / denom[ids]).to(logits.dtype)


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
    eps: float = 0.0,
) -> torch.Tensor:
    """Weighted per-segment mean by scatter-add (``index_add_``); rows whose
    id is at or beyond ``num_segments`` are dropped; empty segments give 0."""
    shape = (-1,) + (1,) * (data.ndim - 1)
    if weights is not None:
        data = data * weights.reshape(shape).to(data.dtype)
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments, weights=weights)
    denom = count.clamp(min=1.0) + eps
    return total / denom.reshape(shape).to(total.dtype)


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
