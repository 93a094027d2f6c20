"""Where the time of the zinc_pyr serving forward goes on the CUDA card.

    python -m hl_hgat_tpu_torch.profile_serving [--dtype float32|bfloat16]
        [--route fused|terms|plain]

Packs 384 synthetic ZINC-like graphs (seed 0), builds a seeded
full-width ``zinc_pyr``, warms up, then traces 5 eval forwards with
``torch.profiler``.  Prints the device time by kernel name, each kernel
class's share, the device busy share of the traced window and the mean
forward time (top 15 kernels), with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.serving import RECOMMENDED_THROUGHPUT_BATCH, Predictor

_ROUTES = {"fused": (True, False), "terms": (False, True), "plain": (False, False)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--route", default="fused", choices=tuple(_ROUTES))
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    conv.use_fused_dense(_ROUTES[args.route][0])
    conv.use_terms_kernel(_ROUTES[args.route][1])
    model, _ = presets.zinc_pyr(compute_dtype=args.dtype, seed=0)
    n = RECOMMENDED_THROUGHPUT_BATCH
    pred = Predictor(model, batch_size=n)
    batch = pred.collate(zinc_like_samples(np.random.default_rng(0), n))
    for _ in range(3):
        pred.forward(batch)
    torch.cuda.synchronize()

    reps = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.forward(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0.0)

    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    rows.sort(reverse=True)
    # kernel-level rows only: aten ops and the autograd.Function labels
    # (``_FusedFunction`` ...) report their kernels' time as self time too
    kernels = [r for r in rows
               if not r[2].startswith(("aten::", "cuda", "Memcpy", "Memset", "_"))]
    total_us = sum(r[0] for r in kernels)
    print(f"[profile] {card} | zinc_pyr batch {n} {args.dtype} {args.route} route")
    print(f"[profile] forward {wall_ms / reps:.3f} ms (wall, mean of {reps}); device kernel "
          f"time {total_us / 1e3 / reps:.3f} ms/forward; device busy "
          f"{100 * total_us / 1e3 / wall_ms:.1f}% of the window")
    for us, count, name in kernels[:15]:
        print(f"[profile] {100 * us / total_us:5.1f}%  {us / 1e3 / reps:8.3f} ms/fwd  "
              f"{count // reps:4d}/fwd  {name[:110]}")


if __name__ == "__main__":
    main()
