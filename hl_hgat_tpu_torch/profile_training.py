"""Where the time of the zinc_pyr training step goes on the CUDA card.

    python -m hl_hgat_tpu_torch.profile_training [--dtype float32|bfloat16]
        [--layout packed|flat] [--route fused|terms|plain | ell|gather|coo]
        [--steps 5]

Batches 384 synthetic ZINC-like graphs (seed 0) in the packed dense-block
layout (conv routes fused, terms, plain) or the flat layout (mat-vec
routes ell: the ELL kernel, gather: its plain version, coo: the scatter),
builds a seeded full-width ``zinc_pyr`` and a ``Trainer`` (L1 loss, Adam lr
1e-3 with L2 1e-3), warms up, then traces ``--steps`` training steps on
the one batch with ``torch.profiler``.  Prints the device time by kernel name, each
kernel's share, the device busy share of the traced window and the mean
step time (top 20 kernels), with the card's name and power limit.  Needs
a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import collate
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.ops import ell_spmm
from hl_hgat_tpu_torch.serving import RECOMMENDED_THROUGHPUT_BATCH
from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

_ROUTES = {"fused": (True, False), "terms": (False, True), "plain": (False, False)}
_FLAT_ROUTES = ("ell", "gather", "coo")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--layout", default="packed", choices=("packed", "flat"))
    ap.add_argument("--route", default=None, choices=tuple(_ROUTES) + _FLAT_ROUTES)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    flat = args.layout == "flat"
    args.route = args.route or ("ell" if flat else "fused")
    if (args.route in _FLAT_ROUTES) != flat:
        ap.error(f"route {args.route!r} does not belong to the {args.layout} layout")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if flat:
        ell_spmm.use_ell_kernel(args.route != "gather")
    else:
        conv.use_fused_dense(_ROUTES[args.route][0])
        conv.use_terms_kernel(_ROUTES[args.route][1])
    model, meta = presets.zinc_pyr(compute_dtype=args.dtype, seed=0)
    trainer = Trainer(model, TrainerConfig(task=meta["task"], lr=1e-3, weight_decay=1e-3))
    n = RECOMMENDED_THROUGHPUT_BATCH
    samples = zinc_like_samples(np.random.default_rng(0), n)
    batch = (collate(samples, with_ell=args.route != "coo") if flat
             else collate_dense_packed(samples)).to(trainer.device)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()

    reps = args.steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0.0)

    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    rows.sort(reverse=True)
    # kernel-level rows only: aten ops report their kernels' time as self
    # time so do the autograd.Function labels (``_FusedFunction`` ...)
    skip = ("aten::", "cuda", "Memcpy", "Memset", "autograd::", "Optimizer.", "_")
    kernels = [r for r in rows if not r[2].startswith(skip) and "Backward" not in r[2]]
    total_us = sum(r[0] for r in kernels)
    ours = ("fused_fwd_mma_kernel", "terms_fwd_mma_kernel", "fused_bwd_dx_mma_kernel",
            "fused_bwd_dw_mma_kernel", "terms_bwd_mma_kernel", "reduce_partials_kernel",
            "cast_w_kernel", "ell_spmm_kernel", "band_step_kernel", "band_out_kernel",
            "band_bar_kernel", "band_dw_kernel", "band_reduce_kernel")
    ours_us = sum(r[0] for r in kernels if any(k in r[2] for k in ours))
    print(f"[profile] {card} | zinc_pyr training step, batch {n} {args.dtype} "
          f"{args.layout} layout, {args.route} route")
    print(f"[profile] step {wall_ms / reps:.3f} ms (wall, mean of {reps}); device kernel "
          f"time {total_us / 1e3 / reps:.3f} ms/step, of it the package's CUDA kernels "
          f"{ours_us / 1e3 / reps:.3f} ms; device busy "
          f"{100 * total_us / 1e3 / wall_ms:.1f}% of the window; "
          f"{len(kernels)} distinct kernels, "
          f"{sum(r[1] for r in kernels) // reps} launches/step")
    for us, count, name in kernels[:20]:
        print(f"[profile] {100 * us / total_us:5.1f}%  {us / 1e3 / reps:8.3f} ms/step  "
              f"{count // reps:4d}/step  {name[:110]}")


if __name__ == "__main__":
    main()
