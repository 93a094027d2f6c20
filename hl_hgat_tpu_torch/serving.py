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
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.dense import DenseBatch, collate_dense_packed, pack_graphs
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
