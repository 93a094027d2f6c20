"""Batch inference (``hl_hgat_tpu/serving.py``).

    model, _ = presets.zinc_pyr(keig=4, in_t=16, in_s=16)   # on the CUDA card
    predictor = Predictor.from_checkpoint(model, "weights/torch/zinc_fold0",
                                          batch_size=RECOMMENDED_THROUGHPUT_BATCH)
    preds = predictor(samples)                    # [N, 1], input order

    model, _ = presets.tsp_pyr()                  # an edge-level model
    edge_preds = Predictor(model, edge_level=True, edge_cap=512)(samples)
                                                  # one [e_i, 1] array a graph

A request rides a packer of its own (``RequestPacker``): the packed
blocks of the training loader (``data/loader.py::BucketedLoader``: one
bucket, no shuffle, ``transfer="derived"`` by default: B1 and the spectral
scales cross to the card and ``maybe_inflate`` rebuilds the operators
there), the same batches array for array, made from arenas of only what the
transfer ships, gathered once for the request and dropped with it.  The
forward runs in eval mode (BN on running statistics, no dropout) under
``torch.inference_mode``.  A short final batch is filled with the request's
smallest graph, whose rows are stripped, so outputs align 1:1 with the
inputs.  Every graph must fit one block of (node_cap, edge_cap) rows, as in
the JAX loader: a larger one raises (batches with graphs spanning blocks
are trained and evaluated through ``train.Trainer``).

    model, _ = presets.hgat_attpool(...)          # the brain family
    out = BrainPredictor(model, levels, pools)(timeseries)
                                                  # dict of per-subject arrays

``BrainPredictor`` serves the shared-skeleton brain models: every subject
rides one ``collate_dense_shared`` batch layout, one operator a level.

With the port's tracing on (``utils/profiling.py``), a ``Predictor`` call
is the unit ``serve.request`` and its layers are the spans
``serve.loader`` (the request packer's set-up: arenas, row pads, filler),
``serve.pack`` (a batch's collate), ``serve.transfer``, ``serve.forward``
(inflate and the forward, issued) and ``serve.readback`` (the host waiting
for the answer).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.compact import level_edge_mask, maybe_inflate
from hl_hgat_tpu_torch.complex.dense import DenseBatch, collate_dense_shared
from hl_hgat_tpu_torch.data.datasets import brain_sample
from hl_hgat_tpu_torch.data.fast_collate import (
    FlatSamples, PackedBatches, batch_row_pad, filler_index)
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.train.checkpoint import restore_checkpoint
from hl_hgat_tpu_torch.utils import profiling

# The JAX package's serving batch for ZINC-sized graphs; here it is the
# batch chip_smoke.py drives, not a measured optimum of this port.
RECOMMENDED_THROUGHPUT_BATCH = 384


class RequestPacker:
    """One request's packed batches, in input order: those of
    ``BucketedLoader(samples, batch_size, shuffle=False, num_buckets=1,
    layout="dense_packed", ...)`` array for array, made from the request's
    own arenas (`FlatSamples`), which hold only what ``transfer`` ships.
    The feature-row pads (`batch_row_pad`), the filler of a short final
    batch (`filler_index`) and the pinned caps hold for this request
    alone."""

    def __init__(self, samples: Sequence[GraphSample], *, batch_size: int, node_cap: int,
                 edge_cap: int, transfer: str, y_per_edge: bool):
        self.flat = FlatSamples(list(samples), transfer=transfer)
        self.batch_size = batch_size
        lvl0 = self.flat.levels[0]
        self.filler = filler_index(lvl0.num_nodes, lvl0.num_edges)
        self.batches = PackedBatches(
            self.flat, transfer=transfer, node_cap=node_cap, edge_cap=edge_cap,
            y_per_edge=y_per_edge, row_pads=(batch_row_pad(lvl0.num_nodes, batch_size),
                                             batch_row_pad(lvl0.num_edges, batch_size)))

    def __len__(self) -> int:
        return -(-len(self.flat) // self.batch_size)

    def __iter__(self):
        count, bs = len(self.flat), self.batch_size
        for lo in range(0, count, bs):
            idx = np.arange(lo, lo + bs, dtype=np.int64)
            idx[idx >= count] = self.filler
            yield self.batches(idx)


class Predictor:
    """Deterministic forward over packed batches, a ``RequestPacker`` a
    request.
    ``edge_level=True`` returns one unpadded array per input graph
    (per-edge outputs, TSP); otherwise one leading-axis row per graph.
    ``transfer`` is the packed collate's: ``"derived"`` (default),
    ``"compact"`` or ``"dense"``."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        batch_size: int = 64,
        edge_level: bool = False,
        node_cap: int = 128,
        edge_cap: int = 0,
        transfer: str = "derived",
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.edge_level = edge_level
        self.node_cap = node_cap
        self.edge_cap = edge_cap or node_cap
        self.transfer = transfer

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, ckpt_dir: str,
                        example_samples: Sequence[GraphSample] | None = None,
                        **kw) -> "Predictor":
        """A predictor serving the ``model`` section of
        ``<ckpt_dir>/state.pt`` (``train/checkpoint.py``; a model-only file
        will do).  ``example_samples`` is accepted for the JAX signature
        and unused: a torch module has its shapes already, where the JAX
        Predictor initializes a restore template from them."""
        self = cls(model, **kw)
        restore_checkpoint(ckpt_dir, self.model)
        return self

    def loader(self, samples: Sequence[GraphSample]) -> RequestPacker:
        """The request packer of ``samples``; iterating it makes the
        request's host batches."""
        with profiling.span("serve.loader"):
            # serving inputs may be unlabeled; the collate wants a y array
            samples = [
                dataclasses.replace(
                    s, y=np.zeros(s.num_edges if self.edge_level else 1, np.float32))
                if s.y is None else s
                for s in samples
            ]
            return RequestPacker(
                samples, batch_size=min(self.batch_size, len(samples)), node_cap=self.node_cap,
                edge_cap=self.edge_cap, transfer=self.transfer, y_per_edge=self.edge_level)

    def collate(self, samples: Sequence[GraphSample]):
        """The first batch the request packer makes of ``samples``, on the
        predictor's device (a compact batch not yet inflated); a graph over
        the caps raises."""
        return next(iter(self.loader(list(samples)))).to(self.device)

    def forward(self, batch) -> torch.Tensor:
        """The model on a batch on the device, inflated first if compact."""
        with profiling.span("serve.forward"), torch.inference_mode():
            out = self.model(maybe_inflate(batch))
        return out[0] if isinstance(out, tuple) else out

    def __call__(self, samples: Sequence[GraphSample]) -> np.ndarray | list[np.ndarray]:
        with profiling.span("serve.request", unit=True):
            return self._serve(list(samples))

    def _serve(self, samples: list[GraphSample]) -> np.ndarray | list[np.ndarray]:
        bs = min(self.batch_size, len(samples))
        outs: list[np.ndarray] = []
        batches = iter(self.loader(samples))
        for i in itertools.count():
            with profiling.span("serve.pack"):
                host = next(batches, None)
            if host is None:
                break
            keep = min(bs, len(samples) - i * bs)  # the rest are filler
            with profiling.span("serve.transfer"):
                batch = host.to(self.device)
            out = self.forward(batch)
            with profiling.span("serve.readback"):
                out = out.float().cpu().numpy()
                if not self.edge_level:
                    outs.append(out[:keep])
                    continue
                # each graph's edge rows, in its own edge order, from the host
                # batch's graph ids: no readback from the device
                lvl = host.levels[0]
                gid = np.asarray(lvl.s_gid).reshape(-1)
                real = np.asarray(level_edge_mask(lvl)).reshape(-1) > 0
                flat = out.reshape((-1,) + out.shape[2:])
                outs.extend(flat[(gid == g) & real] for g in range(keep))
        return outs if self.edge_level else np.concatenate(outs, axis=0)


class BrainPredictor:
    """Inference for the shared-skeleton brain family (``HLHGATAttpool``,
    ``HLHGCNNAbcd``; ``hl_hgat_tpu/serving.py::BrainPredictor``), the
    production form of OHBM_DEMO.ipynb cells 47-49.  Subjects' time series
    become ``brain_sample``s on the shared pyramid (``levels``, ``pools``)
    and ride ``collate_dense_shared`` batches of ``batch_size`` subjects;
    a short final batch is filled with copies of its first subject, whose
    rows are stripped.  Eval mode under ``torch.inference_mode``, on the
    CUDA card unless ``device`` says otherwise."""

    FIELDS = ("pred", "latent", "node_att", "edge_att")

    def __init__(self, model: torch.nn.Module, levels, pools, *, batch_size: int = 16,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.levels, self.pools = list(levels), list(pools)
        self.batch_size = batch_size
        self.src, self.dst = self.levels[0].src, self.levels[0].dst

    def collate(self, series: Sequence[np.ndarray]) -> DenseBatch:
        """One shared-layout batch of the subjects' series on the device."""
        samples = [brain_sample(ts, self.src, self.dst, self.levels, self.pools, y=0.0,
                                y_mean=0.0, y_std=1.0) for ts in series]
        return collate_dense_shared(samples).to(self.device)

    def forward(self, batch: DenseBatch):
        with torch.inference_mode():
            return self.model(batch)

    def __call__(self, timeseries: Sequence[np.ndarray]) -> dict[str, np.ndarray]:
        """timeseries: [R, T] per subject (one T for all).  Returns
        ``pred`` [N, classes] and, from ``HLHGATAttpool``, ``latent``
        [N, D], ``node_att`` [N, n0] and ``edge_att`` [N, e0], float32, in
        input order."""
        series = list(timeseries)
        bs = min(self.batch_size, len(series))
        fields = {k: [] for k in self.FIELDS}
        for lo in range(0, len(series), bs):
            chunk = series[lo : lo + bs]
            keep = len(chunk)
            chunk = chunk + [chunk[0]] * (bs - keep)  # filler, stripped below
            out = self.forward(self.collate(chunk))
            if not isinstance(out, tuple):
                out = (out,)
            for k, v in zip(self.FIELDS, out):
                fields[k].append(v.float().cpu().numpy()[:keep])
        return {k: np.concatenate(v, axis=0) for k, v in fields.items() if v}
