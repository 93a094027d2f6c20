"""Graph (simplex) partitioning: one large complex sharded over the ranks
of the ``graph`` axis (``hl_hgat_tpu/parallel/graph_parallel.py``).

Nodes and edges are split into contiguous row blocks; each rank holds its
rows of every operator and of every feature, and computes its own output
rows.  Two ways to bring in the columns a rank does not own:

* ``sharded_spmm``: an ``all_gather`` of the whole feature block, then the
  local COO product on the owned rows;
* ``halo_spmm``: P − 1 ring rounds that carry only the boundary rows each
  part needs.  Every send and receive is posted first
  (``dist.batch_isend_irecv``); the local-column segment is multiplied
  while the rounds are in flight, and each round's segment is added as its
  block lands.  The backward multiplies by the transpose locally, sends
  each round's halo cotangent back along the reverse ring, and the owner
  adds it into the rows it sent.

The local product is ``ops/spmm.py::spmm_coo``, the plain torch scatter, as
the JAX package's is XLA's: no hand kernel runs on this path.  Under gloo
the blocks that go point to point or through ``all_gather`` are staged
through host memory (gloo reduces CUDA tensors but sends only CPU ones);
under NCCL they stay on the card.

The host-side builders (``partition_complex``, ``partition_halo``) return
every part stacked on a leading axis, as NumPy arrays equal to the JAX
package's bit for bit; ``.local(part, device, group)`` takes one part's
arrays to its rank's device.

Full-model graph parallelism (``gp_model.py``) routes each op that crosses
the row partition through a collective where ``ops/dispatch.py`` and
``nn`` dispatch it: mat-vecs with a `HaloShard`, the boundary couplings and
readouts of a `ShardedLevel`, pooling into coarse rows owned elsewhere, and,
inside ``graph_axis(group)``, the masked BatchNorm statistics and the gate
max.  A forward ``all_reduce`` sum has an ``all_reduce`` sum as its
backward; every rank then holds P times its own share of the gradient of
the sharded layers and the exact gradient of the replicated head, so the
parameter gradients averaged over the graph group are the single-device
ones (``data_parallel.average_gradients``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from hl_hgat_tpu_torch.ops.segment import segment_count, segment_sum
from hl_hgat_tpu_torch.ops.spmm import spmm_coo


# ---------------------------------------------------------------------------
# collectives with gradients
# ---------------------------------------------------------------------------


def _staged(group, t: torch.Tensor) -> bool:
    """True when ``t`` must go through host memory for a send or gather."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _peer(group, part: int) -> int:
    return part if group is None else dist.get_global_rank(group, part)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group's ranks; the backward sums the cotangents."""
    return _AllReduceSum.apply(t, group)


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        hit = (t == out).to(t.dtype)
        ties = hit.clone()
        dist.all_reduce(ties, group=group)
        ctx.save_for_backward(hit / ties.clamp(min=1))
        return out

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g * share, None


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the group's ranks; the summed cotangent goes to
    the ranks that hold the max (split among ties)."""
    return _AllReduceMax.apply(t, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world = dist.get_world_size(group)
        src = x.cpu() if _staged(group, x) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[0] // dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return g[me * n:(me + 1) * n], None


# ---------------------------------------------------------------------------
# which graph group the running model is sharded over
# ---------------------------------------------------------------------------

_GRAPH_AXIS: list = []


@contextlib.contextmanager
def graph_axis(group=None):
    """Within this block the masked BatchNorm statistics and the gate max
    are reduced over ``group`` (None: the default group): the model runs on
    one part of a `ShardedLevel` batch."""
    _GRAPH_AXIS.append(group)
    try:
        yield
    finally:
        _GRAPH_AXIS.pop()


def graph_axis_active() -> bool:
    return bool(_GRAPH_AXIS)


def active_graph_group():
    return _GRAPH_AXIS[-1]


# ---------------------------------------------------------------------------
# all-gather SpMM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphShard:
    """Row-sharded COO operator: ``rows`` are local row ids of a part,
    ``cols`` global ids in the padded gathered layout (part · n_local +
    local).  Host form: [P, nnz_local] NumPy arrays (``part`` None); a
    rank's form: that part's [nnz_local] tensors."""

    rows: Any
    cols: Any
    vals: Any
    n_local: int
    n_parts: int
    part: int | None = None
    group: Any = None

    def local(self, part: int, device, group=None) -> "GraphShard":
        def t(a):
            return torch.as_tensor(np.asarray(a[part])).to(device)

        return dataclasses.replace(self, rows=t(self.rows), cols=t(self.cols),
                                   vals=t(self.vals), part=part, group=group)


def partition_complex(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    n_parts: int,
    *,
    x: np.ndarray | None = None,
) -> tuple[GraphShard, np.ndarray | None]:
    """Split a square COO operator into balanced contiguous row shards;
    with ``x`` also the features padded and reshaped to [P, n_local, F].
    Each part keeps its entries in input order (the JAX package's loop)."""
    n_local = -(-num_rows // n_parts)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    owner = rows // n_local
    nnz_per = np.bincount(owner, minlength=n_parts)
    nnz_local = max(int(nnz_per.max()) if nnz_per.size else 1, 1)

    order = np.argsort(owner, kind="stable")
    starts = np.concatenate([[0], np.cumsum(nnz_per)[:-1]])
    own = owner[order]
    slot = np.arange(order.size) - starts[own]
    r = np.zeros((n_parts, nnz_local), np.int32)
    c = np.zeros((n_parts, nnz_local), np.int32)
    v = np.zeros((n_parts, nnz_local), np.float32)
    r[own, slot] = rows[order] % n_local
    c[own, slot] = cols[order]  # contiguous partition: padded id == global id
    v[own, slot] = vals[order]

    shard = GraphShard(rows=r, cols=c, vals=v, n_local=n_local, n_parts=n_parts)
    if x is None:
        return shard, None
    xp = np.zeros((n_parts * n_local, x.shape[1]), x.dtype)
    xp[:num_rows] = x
    return shard, xp.reshape(n_parts, n_local, x.shape[1])


def sharded_spmm(shard: GraphShard, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """``L @ x`` on this rank's rows: all-gather the [n_local, F] feature
    blocks of every part, then the local COO product.  A host-form shard
    is localized to this rank's part of ``group``."""
    if shard.part is None:
        shard = shard.local(dist.get_rank(group), x_local.device, group)
    x_full = _AllGatherRows.apply(x_local, shard.group)
    return spmm_coo(shard.rows, shard.cols, shard.vals, x_full, shard.n_local)


# ---------------------------------------------------------------------------
# halo-exchange SpMM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloShard:
    """Row-sharded operator with its halo exchange schedule.

    Entries are grouped by the ring round their column arrives in:
    ``seg_nnz[0]`` local-column entries first (cols in [0, c_local)), then
    for rounds r = 1..P−1 ``seg_nnz[r]`` entries whose cols index that
    round's [H, F] halo block, received from part (p − r) mod P.
    ``send_idx[r−1]`` lists the local rows part (p + r) mod P needs from
    us (``send_mask`` marks the real ones of the H slots).  Host form:
    arrays stacked over the parts (``part`` None); a rank's form: its part's
    tensors and the graph group.
    """

    rows: Any  # [P, Σ seg_nnz] local row ids, round-segmented
    cols: Any  # [P, Σ seg_nnz] per-segment column ids
    vals: Any  # [P, Σ seg_nnz]
    send_idx: Any  # [P, max(P−1, 1), H] local col-space rows to send at round r
    send_mask: Any  # [P, max(P−1, 1), H]
    n_local: int  # output rows per part
    c_local: int  # x rows per part (== n_local for square operators)
    n_parts: int
    halo_per_round: int
    seg_nnz: tuple[int, ...] = ()
    part: int | None = None
    group: Any = None

    _ARRAYS = ("rows", "cols", "vals", "send_idx", "send_mask")

    def local(self, part: int, device, group=None) -> "HaloShard":
        """This part's arrays as tensors on ``device``, exchanging over
        ``group`` (None: the default group; ranks are parts)."""
        return dataclasses.replace(
            self, part=part, group=group,
            **{k: torch.as_tensor(np.asarray(getattr(self, k)[part])).to(device)
               for k in self._ARRAYS})

    def to(self, device) -> "HaloShard":
        return dataclasses.replace(
            self, **{k: torch.as_tensor(getattr(self, k)).to(device) for k in self._ARRAYS})

    def rounds(self) -> list[int]:
        """The rounds some part needs (an empty segment on every part is
        never exchanged)."""
        return [r for r in range(1, self.n_parts) if self.seg_nnz[r]]


def partition_halo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    n_parts: int,
    *,
    num_cols: int | None = None,
    x: np.ndarray | None = None,
) -> tuple[HaloShard, np.ndarray | None]:
    """The halo schedule of a contiguous row partition (host NumPy).

    Rectangular operators (``num_cols`` ≠ ``num_rows``: |B1| [nodes ×
    edges], |B1|ᵀ) partition rows in blocks of ``ceil(num_rows/P)`` and
    the x features in blocks of ``ceil(num_cols/P)``; the halo carries
    col-space rows."""
    if num_cols is None:
        num_cols = num_rows
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    n_local = -(-num_rows // n_parts)
    c_local = -(-num_cols // n_parts)
    row_owner = lambda g: g // n_local  # noqa: E731
    owner = lambda g: g // c_local  # noqa: E731  (col-space ownership)

    # per-part needed remote col-space globals, grouped by owning part
    need: list[dict[int, np.ndarray]] = []
    for p in range(n_parts):
        sel = row_owner(rows) == p
        remote = np.unique(cols[sel][owner(cols[sel]) != p])
        need.append({q: np.sort(remote[owner(remote) == q]) for q in np.unique(owner(remote))})
    halo_per_round = 1
    for p in range(n_parts):
        for lst in need[p].values():
            halo_per_round = max(halo_per_round, lst.size)

    # group each part's entries by the ring round their column arrives in
    # (round 0 = local), rebasing cols into that round's block
    per_part: list[list[tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
    seg_counts = np.zeros((n_parts, n_parts), np.int64)
    for p in range(n_parts):
        sel = row_owner(rows) == p
        rr, cc, vv = rows[sel] - p * n_local, cols[sel], vals[sel]
        entry_round = (p - owner(cc)) % n_parts
        segs = []
        for r in range(n_parts):
            in_r = entry_round == r
            cr = cc[in_r]
            if r == 0:
                cr = cr - p * c_local
            else:
                lst = need[p].get((p - r) % n_parts, np.zeros(0, np.int64))
                cr = np.searchsorted(lst, cr)  # position in the halo block
            segs.append((rr[in_r].astype(np.int32), cr.astype(np.int32),
                         vv[in_r].astype(np.float32)))
            seg_counts[p, r] = cr.size
        per_part.append(segs)
    seg_nnz = tuple(max(int(seg_counts[:, r].max()), 1 if r == 0 else 0)
                    for r in range(n_parts))
    total = sum(seg_nnz)

    r_arr = np.zeros((n_parts, total), np.int32)
    c_arr = np.zeros((n_parts, total), np.int32)
    v_arr = np.zeros((n_parts, total), np.float32)
    send_idx = np.zeros((n_parts, max(n_parts - 1, 1), halo_per_round), np.int32)
    send_mask = np.zeros((n_parts, max(n_parts - 1, 1), halo_per_round), np.float32)
    for p in range(n_parts):
        off = 0
        for r in range(n_parts):
            rr, cr, vv = per_part[p][r]
            r_arr[p, off:off + rr.size] = rr
            c_arr[p, off:off + rr.size] = cr
            v_arr[p, off:off + rr.size] = vv
            off += seg_nnz[r]
        # what we send at round r: the col rows (p + r) % P needs from us
        for r in range(1, n_parts):
            lst = need[(p + r) % n_parts].get(p, np.zeros(0, np.int64))
            send_idx[p, r - 1, :lst.size] = lst - p * c_local
            send_mask[p, r - 1, :lst.size] = 1.0

    shard = HaloShard(
        rows=r_arr, cols=c_arr, vals=v_arr, send_idx=send_idx, send_mask=send_mask,
        n_local=n_local, c_local=c_local, n_parts=n_parts,
        halo_per_round=halo_per_round, seg_nnz=seg_nnz)
    if x is None:
        return shard, None
    xp = np.zeros((n_parts * c_local, x.shape[1]), x.dtype)
    xp[:num_cols] = x
    return shard, xp.reshape(n_parts, c_local, x.shape[1])


class _Ring:
    """One exchange of [H, F] blocks over the rounds of a halo shard, every
    send and receive posted at once.  Forward: round r sends to part
    (p + r) and receives from (p − r); ``reverse`` swaps the two."""

    def __init__(self, shard: HaloShard, blocks: dict[int, torch.Tensor], like: torch.Tensor,
                 *, reverse: bool = False):
        p, n = shard.part, shard.n_parts
        group = shard.group
        staged = _staged(group, like)
        self.device = like.device
        self.recv: dict[int, tuple[torch.Tensor, Any]] = {}
        ops, self.keep = [], []
        for r, block in blocks.items():
            to, frm = ((p - r) % n, (p + r) % n) if reverse else ((p + r) % n, (p - r) % n)
            send = block.cpu() if staged else block.contiguous()
            buf = torch.empty(block.shape, dtype=block.dtype,
                              device="cpu" if staged else like.device)
            ops.append(dist.P2POp(dist.isend, send, _peer(group, to), group, tag=r))
            ops.append(dist.P2POp(dist.irecv, buf, _peer(group, frm), group, tag=r))
            self.keep.append(send)
            self.recv[r] = (buf, len(ops) - 1)
        self.works = dist.batch_isend_irecv(ops) if ops else []
        self.done: set[int] = set()

    def _wait(self, i: int) -> None:
        # a gloo receive waited twice blocks: wait each work once
        i = min(i, len(self.works) - 1)
        if i not in self.done:
            self.works[i].wait()
            self.done.add(i)

    def wait(self, r: int) -> torch.Tensor:
        buf, i = self.recv[r]
        self._wait(i)
        return buf.to(self.device)

    def finish(self) -> None:
        for i in range(len(self.works)):
            self._wait(i)


def _segments(shard: HaloShard):
    """(round, rows, cols, vals) of every non-empty segment."""
    off = 0
    for r, s in enumerate(shard.seg_nnz):
        if s:
            yield (r, shard.rows[off:off + s], shard.cols[off:off + s],
                   shard.vals[off:off + s])
        off += s


class _HaloMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        blocks = {r: x[shard.send_idx[r - 1].long()]
                  * shard.send_mask[r - 1][:, None].to(x.dtype) for r in shard.rounds()}
        ring = _Ring(shard, blocks, x)
        out = None
        for r, rows, cols, vals in _segments(shard):
            src = x if r == 0 else ring.wait(r)
            y = spmm_coo(rows, cols, vals, src, shard.n_local)
            out = y if out is None else out + y
        ring.finish()
        return out

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        g = g.contiguous()
        dx = torch.zeros((shard.c_local, g.shape[1]), dtype=g.dtype, device=g.device)
        halos = {}
        for r, rows, cols, vals in _segments(shard):
            if r == 0:
                dx = dx + spmm_coo(cols, rows, vals, g, shard.c_local)
            else:
                halos[r] = spmm_coo(cols, rows, vals, g, shard.halo_per_round)
        for r in shard.rounds():  # a part with an empty segment sends zeros
            if r not in halos:
                halos[r] = torch.zeros((shard.halo_per_round, g.shape[1]), dtype=g.dtype,
                                       device=g.device)
        ring = _Ring(shard, halos, g, reverse=True)
        for r in shard.rounds():
            back = ring.wait(r) * shard.send_mask[r - 1][:, None].to(g.dtype)
            dx = dx.index_add(0, shard.send_idx[r - 1].long(), back)
        ring.finish()
        return dx, None


def halo_matvec(shard: HaloShard, x: torch.Tensor) -> torch.Tensor:
    """One part's ``L @ x`` (x [c_local, ...], trailing axes flattened for
    the product) with the ring exchange; differentiable in x."""
    flat = x.reshape(x.shape[0], -1)
    out = _HaloMatvec.apply(flat, shard)
    return out.reshape((shard.n_local,) + x.shape[1:])


def halo_spmm(shard: HaloShard, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """``L @ x`` on this rank's rows, exchanging only halo rows over P − 1
    ring rounds.  A host-form shard is localized to this rank's part of
    ``group``."""
    if shard.part is None:
        shard = shard.local(dist.get_rank(group), x_local.device, group)
    return halo_matvec(shard, x_local)


def exchange_bytes(shard: HaloShard, features: int, itemsize: int = 4) -> tuple[int, int]:
    """Bytes one mat-vec at width ``features`` moves between ranks, summed
    over the parts: (halo exchange, the all-gather of ``sharded_spmm``)."""
    p = shard.n_parts
    halo = p * len(shard.rounds()) * shard.halo_per_round * features * itemsize
    gather = p * (p - 1) * shard.c_local * features * itemsize
    return halo, gather


# ---------------------------------------------------------------------------
# a level of one complex sharded over the graph axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedLevel:
    """One pyramid level of a graph-sharded complex, as one rank holds it:
    its rows of the masks, graph ids and degrees, and halo shards of L0,
    L1 and the boundary couplings (|B1| nodes × edges, |B1|ᵀ and signed
    B1ᵀ edges × nodes).  Every level size is padded to a multiple of the
    part count; global row id == padded position."""

    node_mask: Any  # [n_local] float32
    edge_mask: Any  # [e_local] float32
    n_id: Any  # [n_local] int32: 0, padding 1 (the dump id)
    s_id: Any  # [e_local] int32
    deg: Any  # [n_local] float32
    l0: HaloShard
    l1: HaloShard
    b1_abs: HaloShard
    b1t_abs: HaloShard
    b1t: HaloShard
    n_parts: int
    part: int
    group: Any = None
    num_graphs: int = 1

    _SHARDS = ("l0", "l1", "b1_abs", "b1t_abs", "b1t")

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    def to(self, device) -> "ShardedLevel":
        moved = {k: torch.as_tensor(getattr(self, k)).to(device)
                 for k in ("node_mask", "edge_mask", "n_id", "s_id", "deg")}
        moved.update({k: getattr(self, k).to(device) for k in self._SHARDS})
        return dataclasses.replace(self, **moved)


def sharded_mean(x: torch.Tensor, ids: torch.Tensor, num_segments: int,
                 weights: torch.Tensor, group, part: int | None = None) -> torch.Tensor:
    """``ops.segment.segment_mean`` over rows spread across the group:
    local weighted sums and counts into every segment, one ``all_reduce``,
    then the division; ``part`` keeps that part's block of the segments
    (num_segments / P rows)."""
    data = x * weights.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    total = segment_sum(data, ids, num_segments).reshape(num_segments, -1)
    count = segment_count(ids, num_segments, weights=weights)
    both = all_reduce_sum(torch.cat([total.float(), count[:, None]], dim=1), group)
    total, count = both[:, :-1].to(x.dtype), both[:, -1]
    if part is not None:
        n = num_segments // dist.get_world_size(group)
        total, count = total[part * n:(part + 1) * n], count[part * n:(part + 1) * n]
    out = total / count.clamp(min=1.0)[:, None].to(total.dtype)
    return out.reshape((out.shape[0],) + x.shape[1:])


def sharded_pool(pool, fine: ShardedLevel, coarse: ShardedLevel, x_t, x_s):
    """The `PoolMap` mean into the coarse level: a fine row's coarse owner
    may be another rank, so each rank sums into every coarse row and the
    sums meet in one ``all_reduce`` a side; coarse padding rows are
    zeroed."""
    nc, ec = coarse.num_nodes * coarse.n_parts, coarse.num_edges * coarse.n_parts
    x_t_c = sharded_mean(x_t, pool.pos_t, nc, fine.node_mask, fine.group, coarse.part)
    x_s_c = sharded_mean(x_s, pool.pos_s, ec, fine.edge_mask, fine.group, coarse.part)
    return (x_t_c * coarse.node_mask[:, None].to(x_t_c.dtype),
            x_s_c * coarse.edge_mask[:, None].to(x_s_c.dtype))
