"""Batch inference for graph-level models (``hl_hgat_tpu/serving.py``).

    model, _ = presets.zinc_pyr()                 # on the CUDA card
    predictor = Predictor(model, batch_size=RECOMMENDED_THROUGHPUT_BATCH)
    preds = predictor(samples)                    # [N, 1], input order

Samples are packed with ``collate_dense_packed``; the forward runs in eval
mode (BN on running statistics, no dropout) under ``torch.inference_mode``.
A short final batch is filled with copies of its first sample, as the JAX
Predictor does, and the filler rows are stripped.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.dense import DenseBatch, collate_dense_packed
from hl_hgat_tpu_torch.device import resolve_device

# The JAX package's serving batch for ZINC-sized graphs; here it is the
# batch chip_smoke.py drives, not a measured optimum of this port.
RECOMMENDED_THROUGHPUT_BATCH = 384


class Predictor:
    def __init__(
        self,
        model: torch.nn.Module,
        *,
        batch_size: int = 64,
        node_cap: int = 128,
        edge_cap: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.node_cap = node_cap
        self.edge_cap = edge_cap or node_cap

    def collate(self, samples: Sequence[GraphSample]) -> DenseBatch:
        """One packed batch on the predictor's device."""
        return collate_dense_packed(
            list(samples), node_cap=self.node_cap, edge_cap=self.edge_cap
        ).to(self.device)

    def forward(self, batch: DenseBatch) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(batch)

    def __call__(self, samples: Sequence[GraphSample]) -> np.ndarray:
        # serving inputs may be unlabeled; the collate wants a y array
        samples = [
            dataclasses.replace(s, y=np.zeros(1, np.float32)) if s.y is None else s
            for s in samples
        ]
        bs = min(self.batch_size, len(samples))
        outs = []
        for lo in range(0, len(samples), bs):
            chunk = samples[lo : lo + bs]
            keep = len(chunk)
            chunk = chunk + [chunk[0]] * (bs - keep)  # filler, stripped below
            out = self.forward(self.collate(chunk))
            outs.append(out[:keep].float().cpu().numpy())
        return np.concatenate(outs, axis=0)
