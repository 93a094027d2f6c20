"""Batch inference (``hl_hgat_tpu/serving.py``).

    model, _ = presets.zinc_pyr()                 # on the CUDA card
    predictor = Predictor(model, batch_size=RECOMMENDED_THROUGHPUT_BATCH)
    preds = predictor(samples)                    # [N, 1], input order

    model, _ = presets.tsp_pyr()                  # an edge-level model
    edge_preds = Predictor(model, edge_level=True, edge_cap=512)(samples)
                                                  # one [e_i, 1] array a graph

Samples are packed with ``collate_dense_packed``; the forward runs in eval
mode (BN on running statistics, no dropout) under ``torch.inference_mode``.
A short final batch is filled with copies of its first sample, as the JAX
Predictor does, and the filler rows are stripped.  Every graph must fit one
block of (node_cap, edge_cap) rows, as in the JAX loader: a larger one
raises (batches with graphs spanning blocks are trained and evaluated
through ``train.Trainer``).

    model, _ = presets.hgat_attpool(...)          # the brain family
    out = BrainPredictor(model, levels, pools)(timeseries)
                                                  # dict of per-subject arrays

``BrainPredictor`` serves the shared-skeleton brain models: every subject
rides one ``collate_dense_shared`` batch layout, one operator a level.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.dense import (
    DenseBatch,
    collate_dense_packed,
    collate_dense_shared,
    pack_graphs,
)
from hl_hgat_tpu_torch.data.datasets import brain_sample
from hl_hgat_tpu_torch.device import resolve_device

# The JAX package's serving batch for ZINC-sized graphs; here it is the
# batch chip_smoke.py drives, not a measured optimum of this port.
RECOMMENDED_THROUGHPUT_BATCH = 384


class Predictor:
    """Deterministic forward over packed batches.  ``edge_level=True``
    returns one unpadded array per input graph (per-edge outputs, TSP);
    otherwise one leading-axis row per graph."""

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        batch_size: int = 64,
        edge_level: bool = False,
        node_cap: int = 128,
        edge_cap: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.edge_level = edge_level
        self.node_cap = node_cap
        self.edge_cap = edge_cap or node_cap

    def collate(self, samples: Sequence[GraphSample]) -> DenseBatch:
        """One packed batch on the predictor's device; a graph over the caps
        raises."""
        samples = list(samples)
        return collate_dense_packed(
            samples, node_cap=self.node_cap, edge_cap=self.edge_cap,
            y_per_edge=self.edge_level,
            bins=pack_graphs(samples, self.node_cap, self.edge_cap),
        ).to(self.device)

    def forward(self, batch: DenseBatch) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(batch)

    def __call__(self, samples: Sequence[GraphSample]) -> np.ndarray | list[np.ndarray]:
        # serving inputs may be unlabeled; the collate wants a y array
        samples = [
            dataclasses.replace(
                s, y=np.zeros(s.num_edges if self.edge_level else 1, np.float32))
            if s.y is None else s
            for s in samples
        ]
        bs = min(self.batch_size, len(samples))
        outs = []
        for lo in range(0, len(samples), bs):
            chunk = samples[lo : lo + bs]
            keep = len(chunk)
            chunk = chunk + [chunk[0]] * (bs - keep)  # filler, stripped below
            batch = self.collate(chunk)
            out = self.forward(batch).float().cpu().numpy()
            if not self.edge_level:
                outs.append(out[:keep])
                continue
            # each graph's edge rows, in its own edge order
            lvl = batch.level0
            gid = lvl.s_gid.reshape(-1).cpu().numpy()
            real = lvl.edge_mask.reshape(-1).cpu().numpy() > 0
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
