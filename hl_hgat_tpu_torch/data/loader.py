"""Bucketed batch loader (``hl_hgat_tpu/data/loader.py``).

Replaces the PyG ragged ``DataLoader`` (reference main_zinc...py:223-225):
samples are grouped into a few size buckets (quantiles of nodes + edges),
shuffled per epoch and collated on the host, each bucket padded to sizes
fixed over the run.  The batches are NumPy (``bfloat16`` features are
torch tensors); the trainer moves them to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample, LevelPad, attach_link_pairs, collate
from hl_hgat_tpu_torch.complex.compact import NNZ_MULTIPLE, ROW_MULTIPLE
from hl_hgat_tpu_torch.complex.dense import _ROW_MULTIPLE
from hl_hgat_tpu_torch.data.fast_collate import (
    FlatSamples, collate_packed_compact, collate_packed_fast, pack_indices)


def _sample_cost(s: GraphSample) -> int:
    return s.num_nodes + s.num_edges


def _rnd(x: int, m: int) -> int:
    return max(-(-int(x) // m) * m, m)


@dataclasses.dataclass
class BucketedLoader:
    """``layout``:

    * ``"coo"``: the flat `ComplexBatch` (``complex/build.py::collate``);
    * ``"dense_packed"``: the packed `DenseBatch` of
      ``data/fast_collate.py`` (several small graphs a 128-row block), the
      block count rounded up to a multiple of 16, coarse levels on level
      0's bins and caps.
    """

    samples: Sequence[GraphSample]
    batch_size: int
    shuffle: bool = True
    num_buckets: int = 1
    y_per_edge: bool = False
    # per-node labels (PascalVOC-SP / COCO-SP); coo layout only
    y_per_node: bool = False
    seed: int = 0
    layout: str = "coo"
    node_cap: int = 128
    edge_cap: int = 128
    # dense_packed only: "dense" ships the dense blocks; "compact" ships COO
    # operator triplets that the trainer densifies on the card
    # (complex/compact.py inflate); "derived" ships only B1 and per-graph
    # 2/λmax, and two batched products rebuild L0/L1 on the card (≤ 1 ulp);
    # both ship only the real feature rows, no masks, int16 id columns
    transfer: str = "dense"
    # "bfloat16" casts x_t/x_s on the host (round to nearest even, the same
    # bits as a cast on the card) for a model that computes in bfloat16
    feature_dtype: str = "float32"
    # link-prediction queries (coo only): (n_queries, n_neg) per graph,
    # drawn afresh each epoch (complex/build.py attach_link_pairs)
    link_queries: tuple[int, int] | None = None
    # fill a short final batch with the bucket's smallest sample to keep
    # num_graphs fixed; False for exact evaluation metrics
    pad_final: bool = True
    # ``samples`` holds ``variants`` consecutive augmentation rolls per
    # graph (data/ingest.py aug_variants); epoch e serves variant
    # (e + i) % variants of graph i
    variants: int = 1

    def __post_init__(self):
        if self.layout not in ("coo", "dense_packed"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.y_per_node and self.layout != "coo":
            raise ValueError("y_per_node labels need layout='coo'")
        if self.transfer not in ("dense", "compact", "derived"):
            raise ValueError(f"unknown transfer {self.transfer!r}")
        if self.feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown feature_dtype {self.feature_dtype!r}")
        if self.variants > 1 and len(self.samples) % self.variants:
            raise ValueError(f"{len(self.samples)} samples not divisible by "
                             f"variants={self.variants}")
        costs = np.asarray([_sample_cost(s) for s in self.samples])
        if self.variants > 1:
            # bucket by group (its worst variant): every roll of a graph
            # lands in one bucket, so shapes stay fixed across epochs
            costs = np.repeat(costs.reshape(-1, self.variants).max(axis=1), self.variants)
        if self.num_buckets > 1:
            qs = np.quantile(costs, np.linspace(0, 1, self.num_buckets + 1)[1:-1])
            self._bucket_of = np.searchsorted(qs, costs)
        else:
            self._bucket_of = np.zeros(len(self.samples), np.int64)
        # per-bucket pad spec: the sums of the bucket's batch_size largest
        # samples, each resource on its own
        self._pads: list[list[LevelPad]] = []
        depth = len(self.samples[0].levels)
        for b in range(self.num_buckets):
            idx = np.nonzero(self._bucket_of == b)[0]
            members = [self.samples[i] for i in idx] or list(self.samples)
            pads = []
            for lv in range(depth):
                def worst(key):
                    vals = sorted((key(s.levels[lv]) for s in members), reverse=True)
                    total = sum(vals[: self.batch_size])
                    # a bucket smaller than batch_size is filled with its
                    # smallest member
                    if len(vals) < self.batch_size:
                        total += (self.batch_size - len(vals)) * vals[-1]
                    return _rnd(total, _ROW_MULTIPLE)

                pads.append(LevelPad(
                    nodes=worst(lambda st: st.num_nodes), edges=worst(lambda st: st.num_edges),
                    nnz0=worst(lambda st: st.l0_rows.size),
                    nnz1=worst(lambda st: st.l1_rows.size)))
            self._pads.append(pads)
        # per-bucket smallest member, the filler of short final batches
        self._filler_idx: list[int] = []
        for b in range(self.num_buckets):
            idx = np.nonzero(self._bucket_of == b)[0]
            cand = idx if idx.size else np.arange(len(self.samples))
            self._filler_idx.append(int(min(cand, key=lambda i: _sample_cost(self.samples[i]))))
        if self.layout == "dense_packed":
            # flattened once for the per-epoch native collate
            self._flat = FlatSamples(list(self.samples))
            # Pinned per-bucket caps of the compact/derived transfer, seeded
            # from the bucket's first batch with a margin and raised only
            # when a batch exceeds them: one set of shapes per bucket.
            self._compact_pins: dict[int, dict] = {}
            if self.transfer in ("compact", "derived"):
                def seg_counts(flags, off):
                    c = np.concatenate([[0], np.cumsum(flags.astype(np.int64))])
                    return c[off[1:]] - c[off[:-1]]

                # per-sample counts of kept pool entries (assignment >= 0)
                self._pool_valid = [
                    (seg_counts(self._flat.c_node[lv] >= 0, self._flat.cn_off[lv]),
                     seg_counts(self._flat.c_edge[lv] >= 0, self._flat.ce_off[lv]))
                    for lv in range(self._flat.depth - 1)]
        self._epoch = 0

    def _compact_caps(self, bucket: int, idx: np.ndarray, n_bins: int):
        """Pinned (num_blocks, nnz_caps, pool_caps) for one batch."""
        need = {"blocks": n_bins, "nnz": [], "pool": []}
        for fl in self._flat.levels:
            need["nnz"].append(tuple(int((off[idx + 1] - off[idx]).sum())
                                     for off in (fl.l0_off, fl.l1_off, fl.e_off)))
        for t, s in self._pool_valid:
            need["pool"].append(max(int(t[idx].sum()), int(s[idx].sum())))
        margin = lambda x, m: _rnd(x + max(x // 16, m // 2), m)  # noqa: E731
        pins = self._compact_pins.get(bucket)
        if pins is None:
            pins = {"blocks": _rnd(need["blocks"] + 4, 4),
                    "nnz": [tuple(margin(x, NNZ_MULTIPLE) for x in tri) for tri in need["nnz"]],
                    "pool": [margin(x, NNZ_MULTIPLE) for x in need["pool"]]}
            self._compact_pins[bucket] = pins
        else:  # raise any exceeded field
            if need["blocks"] > pins["blocks"]:
                pins["blocks"] = _rnd(need["blocks"] + 4, 4)
            pins["nnz"] = [tuple(margin(x, NNZ_MULTIPLE) if x > c else c
                                 for x, c in zip(tri, cur))
                           for tri, cur in zip(need["nnz"], pins["nnz"])]
            pins["pool"] = [margin(x, NNZ_MULTIPLE) if x > c else c
                            for x, c in zip(need["pool"], pins["pool"])]
        return pins["blocks"], pins["nnz"], pins["pool"]

    @property
    def pad_specs(self) -> list[list[LevelPad]]:
        return self._pads

    def __len__(self) -> int:
        return -(-(len(self.samples) // self.variants) // self.batch_size)

    def set_epoch(self, epoch: int) -> "BucketedLoader":
        """Serve epoch ``epoch`` (0-based) next: its shuffle, augmentation
        variants and link queries.  A resumed run positions its loaders so,
        and then sees the batches a straight run does."""
        self._epoch = epoch
        return self

    def __iter__(self) -> Iterator:
        ep = self._epoch
        rng = np.random.default_rng(self.seed + ep)
        self._epoch += 1
        if self.variants > 1:
            groups = np.arange(len(self.samples) // self.variants)
            if self.shuffle:
                rng.shuffle(groups)
            # a fresh roll per graph per epoch, decorrelated across graphs
            order = groups * self.variants + (ep + groups) % self.variants
        else:
            order = np.arange(len(self.samples))
            if self.shuffle:
                rng.shuffle(order)
        for b in range(self.num_buckets):
            members = order[self._bucket_of[order] == b]
            for i in range(0, len(members), self.batch_size):
                chunk = members[i : i + self.batch_size]
                n_fill = self.batch_size - len(chunk) if self.pad_final else 0
                idx = np.concatenate([chunk, np.full(n_fill, self._filler_idx[b])]).astype(np.int64)
                if self.layout == "dense_packed":
                    yield self._cast_features(self._packed(b, idx))
                    continue
                batch_samples = [self.samples[j] for j in idx]
                batch = self._cast_features(collate(
                    batch_samples, self._pads[b], y_per_edge=self.y_per_edge,
                    y_per_node=self.y_per_node))
                if self.link_queries is not None:
                    nq, nneg = self.link_queries
                    batch = attach_link_pairs(
                        batch, batch_samples,
                        np.random.default_rng(self.seed * 100003 + ep * 131 + i),
                        n_queries=nq, n_neg=nneg)
                yield batch

    def _packed(self, bucket: int, idx: np.ndarray):
        bins = pack_indices(self._flat, idx, self.node_cap, self.edge_cap)
        kw = dict(node_cap=self.node_cap, edge_cap=self.edge_cap, y_per_edge=self.y_per_edge,
                  bins=bins,
                  # coarse levels are smaller than level 0, whose caps bound them
                  level_caps=[(self.node_cap, self.edge_cap)] * (self._flat.depth - 1))
        if self.transfer == "dense":
            return collate_packed_fast(self._flat, idx, num_blocks=_rnd(len(bins), 16), **kw)
        num_blocks, nnz_caps, pool_caps = self._compact_caps(bucket, idx, len(bins))
        # feature rows fixed per bucket: its worst-case level-0 row totals
        pad0 = self._pads[bucket][0]
        row_caps = (_rnd(pad0.nodes, ROW_MULTIPLE), _rnd(pad0.edges, ROW_MULTIPLE))
        return collate_packed_compact(
            self._flat, idx, num_blocks=num_blocks, nnz_caps=nnz_caps, pool_caps=pool_caps,
            operators="derived" if self.transfer == "derived" else "coo",
            row_caps=row_caps, **kw)

    def _cast_features(self, batch):
        if self.feature_dtype == "float32":
            return batch
        cast = lambda a: torch.from_numpy(np.asarray(a)).to(torch.bfloat16)  # noqa: E731
        return dataclasses.replace(batch, x_t=cast(batch.x_t), x_s=cast(batch.x_s))
