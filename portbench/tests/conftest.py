"""Small cells for the CPU tests: the benchmark's own files, the widths and
batches cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import fmri

ROOT = Path(__file__).resolve().parents[2]

SMALL_CONFIG = {
    "zinc_pyr": {"model": {"channels": [1, 2, 1], "filters": [24, 32, 40], "k": 3,
                           "mlp_channels": [16, 8]}},
    "hgat_attpool": {"model": {"channels": [1, 1, 1], "filters": [8, 8, 16], "k": 3,
                               "mlp_channels": [8]},
                     "data": {"t_len": 32}},
}
SMALL_MIX = {
    "train_b2048": {"batch_graphs": 24},
    "train_b64": {"batch_graphs": 3},
    "serve_r1024": {"request_graphs": 16, "pool_graphs": 64, "rate_per_s": 50.0,
                    "check_requests": 3, "warmup_requests": 1},
}


# A cell whose files stay under portbench/ while a fault of the port keeps it
# out of BENCHMARK.json (PERF.md, Open questions); the tests still hold its
# reference to the port and its limits to the faults.
HELD_OUT = {
    "configs": [{"name": "hgat_attpool", "file": "portbench/configs/hgat_attpool.json"}],
    "workloads": [{"name": "hgat_attpool.train.b64", "config": "hgat_attpool",
                   "traffic": "train_b64", "chips": 1}],
}


def bench() -> dict:
    """BENCHMARK.json with the held-out cells beside its own."""
    out = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in HELD_OUT.items():
        names = {e["name"] for e in out[key]}
        out[key] += [e for e in entries if e["name"] not in names]
    return out


def small_cell(name: str, tmp_path, *, traced: bool = False) -> spec.Cell:
    cell = spec.load_cell(ROOT, name, str(tmp_path), traced=traced, bench=bench())
    for key, value in SMALL_CONFIG[cell.workload["config"]].items():
        cell.config[key].update(value)
    cell.mix.update(SMALL_MIX[cell.workload["traffic"]])
    return cell


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def small_skeleton(monkeypatch):
    """A 40-node skeleton and its two-level pyramid, built by the port's
    MLGC, in place of Shen-268 (whose dense level-0 L1 is 324 MB)."""
    from hl_hgat_tpu_torch.data.brain import brain_pyramid

    rng = np.random.default_rng(3)
    n = 40
    pairs = {(int(min(a, b)), int(max(a, b))) for a, b in rng.integers(0, n, (160, 2)) if a != b}
    pairs |= {(i, i + 1) for i in range(n - 1)}
    src, dst = np.array(sorted(pairs)).T
    val = rng.random(src.size)
    levels, pools = brain_pyramid(src, dst, val, pool_num=2)
    skel = dict(skeleton_src=src, skeleton_dst=dst, skeleton_val=val,
                num_node=np.array([lv.num_nodes for lv in levels]),
                num_edge=np.array([lv.num_edges for lv in levels]))
    for k, (c_node, c_edge) in enumerate(pools):
        skel[f"pos_t{k}"] = np.where(c_node < 0, np.inf, c_node).astype(np.float32)[:, None]
        skel[f"pos_s{k}"] = np.where(c_edge < 0, np.inf, c_edge).astype(np.float32)[:, None]
    for k in (1, 2):
        skel[f"l{k}_edge_index"] = np.stack([levels[k].src, levels[k].dst]).astype(np.int64)
    monkeypatch.setattr(fmri, "skeleton", lambda: skel)
    from portbench.configs import hgat_attpool

    hgat_attpool._pyramid.cache_clear()  # the port's pyramid of this skeleton
    yield skel
    hgat_attpool._pyramid.cache_clear()
