"""Packed dense-block batch layout, NumPy build + torch transfer.

Port of the superblock packing in ``hl_hgat_tpu/complex/dense.py``: several
small graphs share one [S, S] tile with block-diagonal operators, and
``n_gid``/``s_gid`` carry each row's graph id (padding rows point at
``num_graphs``, the dump bucket).  Every sparse op of the model becomes a
batched dense matmul on [G, S, *] tiles.  A pooled sample's coarsened levels
are packed into the same blocks as level 0, and each coarsening step
becomes a pair of dense averaging operators (`DensePool`).

Every graph must fit one block: the spill and band operators of the JAX
layout (graphs spanning blocks) are not ported yet, so a sample over the
caps raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.batch import ComplexBatch
from hl_hgat_tpu_torch.complex.build import GraphSample


def _to(v, device):
    return torch.as_tensor(v).to(device)


@dataclasses.dataclass
class DenseLevel:
    """One level in packed dense-block layout (NumPy arrays or tensors)."""

    l0: Any  # [G, S, S]
    l1: Any  # [G, E, E]
    b1: Any  # [G, S, E] signed incidence (−1 src, +1 dst)
    node_mask: Any  # [G, S]
    edge_mask: Any  # [G, E]
    deg: Any  # [G, S]
    num_graphs: int
    n_gid: Any  # [G, S] int32, padding rows = num_graphs
    s_gid: Any  # [G, E] int32

    def to(self, device) -> "DenseLevel":
        return dataclasses.replace(
            self,
            **{
                f.name: _to(getattr(self, f.name), device)
                for f in dataclasses.fields(self)
                if f.name != "num_graphs"
            },
        )


@dataclasses.dataclass
class DensePool:
    """Fine→coarse averaging operators of one coarsening step, row-stochastic
    over each coarse row's members."""

    p_t: Any  # [G, S_c, S_f]
    p_s: Any  # [G, E_c, E_f]

    def to(self, device) -> "DensePool":
        return DensePool(p_t=_to(self.p_t, device), p_s=_to(self.p_s, device))


@dataclasses.dataclass
class DenseBatch:
    x_t: Any  # [G, S, Ft]
    x_s: Any  # [G, E, Fs]
    y: Any  # [num_graphs, ...]
    levels: tuple[DenseLevel, ...]
    num_graphs: int
    pools: tuple[DensePool, ...] = ()

    @property
    def level0(self) -> DenseLevel:
        return self.levels[0]

    def replace(self, **kw) -> "DenseBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DenseBatch":
        """Every array as a tensor on ``device``."""
        return DenseBatch(
            x_t=_to(self.x_t, device),
            x_s=_to(self.x_s, device),
            y=_to(self.y, device),
            levels=tuple(lvl.to(device) for lvl in self.levels),
            num_graphs=self.num_graphs,
            pools=tuple(p.to(device) for p in self.pools),
        )


# Either layout of a batch: what the models and the trainer take.
Batch = DenseBatch | ComplexBatch


# Deterministic FFD sort keys, best-of kept.  Must stay identical to
# hl_hgat_tpu/complex/dense.py::_PACK_SORT_KEYS (same orders, same tie-break)
# so both packages place every graph in the same slot.
_PACK_SORT_KEYS = (
    lambda n, e: max(n, e),
    lambda n, e: n + e,
    lambda n, e: e,
    lambda n, e: n,
)


def pack_plan(
    samples: list[GraphSample], node_cap: int, edge_cap: int
) -> list[list[int]]:
    """First-fit-decreasing bin packing by level-0 (nodes, edges), tried
    under each sort key in ``_PACK_SORT_KEYS``; the fewest bins win, the
    earliest key on ties.  A graph over either cap raises."""
    for i, s in enumerate(samples):
        if s.num_nodes > node_cap or s.num_edges > edge_cap:
            raise ValueError(
                f"graph {i} ({s.num_nodes} nodes, {s.num_edges} edges) "
                f"exceeds pack caps ({node_cap}, {edge_cap})"
            )

    def ffd(order: list[int]) -> list[list[int]]:
        bins: list[list[int]] = []
        rem_n: list[int] = []
        rem_e: list[int] = []
        for i in order:
            n, e = samples[i].num_nodes, samples[i].num_edges
            for b in range(len(rem_n)):
                if rem_n[b] >= n and rem_e[b] >= e:
                    bins[b].append(i)
                    rem_n[b] -= n
                    rem_e[b] -= e
                    break
            else:
                bins.append([i])
                rem_n.append(node_cap - n)
                rem_e.append(edge_cap - e)
        return bins

    best: list[list[int]] = []
    for key in _PACK_SORT_KEYS:
        order = sorted(
            range(len(samples)),
            key=lambda i: (-key(samples[i].num_nodes, samples[i].num_edges), i),
        )
        bins = ffd(order)
        if not best or len(bins) < len(best):
            best = bins
    return best


def collate_dense_packed(
    samples: list[GraphSample],
    *,
    node_cap: int = 128,
    edge_cap: int = 128,
    level_caps: list[tuple[int, int]] | None = None,
) -> DenseBatch:
    """Pack several graphs per dense block (block-diagonal operators).

    ``hl_hgat_tpu.complex.dense.collate_dense_packed`` without spill: level-0
    blocks of (node_cap, edge_cap) rows, each rounded up to a multiple of 8,
    as many as ``pack_plan`` needs.  Coarser levels reuse level 0's
    graph→block assignment with the caps of their largest block (rounded
    up), or ``level_caps`` [(nodes, edges)] per level ≥ 1 for fixed shapes;
    a block over its given caps raises.  Per coarsening step a `DensePool`
    holds the row-stochastic averaging operators (each coarse row averages
    its fine members; deleted edges and padding belong to no row).
    """
    bins = pack_plan(samples, node_cap, edge_cap)
    ng = len(samples)
    nb = len(bins)
    depth = len(samples[0].levels)
    rnd = lambda x: max(-(-x // 8) * 8, 8)  # noqa: E731

    # per level: the block shape and every graph's global (node, edge) slot
    caps: list[tuple[int, int]] = []
    offs: list[dict[int, tuple[int, int]]] = []
    for lv in range(depth):
        fill = [(sum(samples[i].levels[lv].num_nodes for i in members),
                 sum(samples[i].levels[lv].num_edges for i in members)) for members in bins]
        if lv == 0:
            s_lv, e_lv = rnd(node_cap), rnd(edge_cap)
        elif level_caps is not None:
            cn, ce = level_caps[lv - 1]
            max_n, max_e = max(n for n, _ in fill), max(e for _, e in fill)
            if max_n > cn or max_e > ce:
                raise ValueError(f"level {lv} bin ({max_n}, {max_e}) exceeds caps ({cn}, {ce})")
            s_lv, e_lv = rnd(cn), rnd(ce)
        else:
            s_lv, e_lv = rnd(max(n for n, _ in fill)), rnd(max(e for _, e in fill))
        caps.append((s_lv, e_lv))
        placement: dict[int, tuple[int, int]] = {}
        for b, members in enumerate(bins):
            no = eo = 0
            for i in members:
                placement[i] = (b * s_lv + no, b * e_lv + eo)
                no += samples[i].levels[lv].num_nodes
                eo += samples[i].levels[lv].num_edges
        offs.append(placement)

    levels = []
    for lv in range(depth):
        s_pad, e_pad = caps[lv]
        l0 = np.zeros((nb, s_pad, s_pad), np.float32)
        l1 = np.zeros((nb, e_pad, e_pad), np.float32)
        b1 = np.zeros((nb, s_pad, e_pad), np.float32)
        nm = np.zeros((nb * s_pad,), np.float32)
        em = np.zeros((nb * e_pad,), np.float32)
        deg = np.zeros((nb * s_pad,), np.float32)
        n_gid = np.full((nb * s_pad,), ng, np.int32)
        s_gid = np.full((nb * e_pad,), ng, np.int32)
        for i, s in enumerate(samples):
            st = s.levels[lv]
            ns, es = offs[lv][i]
            n, e = st.num_nodes, st.num_edges
            blk, no, eo = ns // s_pad, ns % s_pad, es % e_pad
            l0[blk, no + st.l0_rows, no + st.l0_cols] = st.l0_vals
            l1[blk, eo + st.l1_rows, eo + st.l1_cols] = st.l1_vals
            ecols = eo + np.arange(e)
            b1[blk, no + st.src, ecols] = -1.0
            b1[blk, no + st.dst, ecols] = 1.0
            nm[ns : ns + n] = 1.0
            em[es : es + e] = 1.0
            np.add.at(deg, ns + st.src, 1.0)
            np.add.at(deg, ns + st.dst, 1.0)
            n_gid[ns : ns + n] = i
            s_gid[es : es + e] = i
        levels.append(DenseLevel(
            l0=l0, l1=l1, b1=b1,
            node_mask=nm.reshape(nb, s_pad),
            edge_mask=em.reshape(nb, e_pad),
            deg=deg.reshape(nb, s_pad),
            num_graphs=ng,
            n_gid=n_gid.reshape(nb, s_pad),
            s_gid=s_gid.reshape(nb, e_pad),
        ))

    pools = []
    for lv in range(depth - 1):
        mats = []
        for which, pick in ((0, lambda st: st.num_nodes), (1, lambda st: st.num_edges)):
            rows_c, rows_f = caps[lv + 1][which], caps[lv][which]
            p = np.zeros((nb, rows_c, rows_f), np.float32)
            for i, s in enumerate(samples):
                assign = np.asarray(s.pools[lv][which]).reshape(-1)
                members = np.nonzero(assign >= 0)[0]
                r_gl = offs[lv + 1][i][which] + assign[members].astype(np.int64)
                c_gl = offs[lv][i][which] + members
                # each coarse row averages its members (all in this graph)
                cnt = np.bincount(assign[members], minlength=pick(s.levels[lv + 1]))
                p[r_gl // rows_c, r_gl % rows_c, c_gl % rows_f] = (
                    1.0 / np.maximum(cnt[assign[members]], 1.0)).astype(np.float32)
            mats.append(p)
        pools.append(DensePool(p_t=mats[0], p_s=mats[1]))

    (s0, e0), ft, fs = caps[0], samples[0].x_t.shape[1], samples[0].x_s.shape[1]
    x_t = np.zeros((nb * s0, ft), np.float32)
    x_s = np.zeros((nb * e0, fs), np.float32)
    for i, s in enumerate(samples):
        ns, es = offs[0][i]
        x_t[ns : ns + s.num_nodes] = s.x_t
        x_s[es : es + s.num_edges] = s.x_s
    y = np.stack([np.asarray(s.y, np.float32).reshape(-1) for s in samples])
    return DenseBatch(
        x_t=x_t.reshape(nb, s0, ft),
        x_s=x_s.reshape(nb, e0, fs),
        y=y,
        levels=tuple(levels),
        num_graphs=ng,
        pools=tuple(pools),
    )
