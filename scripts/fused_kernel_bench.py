#!/usr/bin/env python3
"""The fused Laguerre kernels (forward and backward) on one CUDA card:
build, registers and spills, kernel against plain version, times.

    python3 scripts/fused_kernel_bench.py [--quick] [--graph-blocks 78]

Builds ``hl_hgat_tpu_torch/csrc`` with nvcc, prints what ``-Xptxas=-v``
reports for the fused kernels, then for every shape and dtype holds
``laguerre_dense_fused`` and ``laguerre_dense_fused_bwd`` against their
plain versions (float32 <= 1e-4·max|ref|, bfloat16 <= 2e-2·max|ref|), checks
that a second launch gives the same bits, and times kernel and plain
version: device time by kernel from ``torch.profiler`` over 10 calls, and
one call between two CUDA events (median of 20; for a kernel of a few µs
that is the wrapper's and the launch's time).  L is a symmetric random
matrix scaled to a spectrum of order one.  ``--quick`` checks without
timing.  Exits non-zero on the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import statistics
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (S, C, F, K): the four zinc_pyr shapes, then ragged and limit shapes
MAIN = [(128, 64, 64, 1), (128, 64, 64, 6), (128, 128, 128, 6), (128, 256, 256, 6)]
EXTRA = [(128, 100, 72, 3), (128, 64, 64, 8), (96, 128, 128, 6), (13, 7, 130, 1),
         (30, 33, 65, 2), (96, 300, 8, 6), (128, 512, 256, 6), (128, 40, 300, 2)]


def median_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, calls=10):
    """Device time of one call of ``fn`` by kernel (``torch.profiler`` over
    ``calls`` calls): an event pair around one call of a kernel of a few µs
    measures the wrapper and the launch instead."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
            name = evt.key.split("<")[0].split("::")[-1].split("(")[0].strip()[:28]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="check only, no timing")
    ap.add_argument("--graph-blocks", type=int, default=78)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from hl_hgat_tpu_torch import cuda_build
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    torch.backends.cuda.matmul.allow_tf32 = False
    for name, log in cuda_build.build().items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            hit = re.search(r"(fused_\w+?_kernel)I(f|13__nv_bfloat16)(?:Li(\d)E)?", line)
            if "Compiling entry" in line and hit:
                what = " ".join(x.strip().replace("ptxas info    : ", "") for x in lines[i + 1:i + 4]
                                if "registers" in x or "bytes stack" in x)
                print(f"[build] {hit.group(1)}<{'float' if hit.group(2) == 'f' else 'bfloat16'}"
                      f"{', ' + hit.group(3) if hit.group(3) else ''}>: {what}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    g = args.graph_blocks
    rng = np.random.default_rng(0)
    bad = 0
    for s, c, f, k in MAIN + EXTRA:
        l32 = rng.standard_normal((g, s, s)).astype(np.float32)
        l32 = (l32 + l32.transpose(0, 2, 1)) / (2 * np.sqrt(s))
        x32 = rng.standard_normal((g, s, c)).astype(np.float32)
        w = torch.from_numpy(
            (rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).cuda()
        cot32 = rng.standard_normal((g, s, f)).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            l, x, cot = (torch.from_numpy(a).cuda().to(td) for a in (l32, x32, cot32))
            runs = {
                "fwd": (lambda: lg.laguerre_dense_fused(l, x, w, b),
                        lambda: lg.laguerre_dense_fused_plain(l, x, w, b)),
                "bwd": (lambda: lg.laguerre_dense_fused_bwd(l, x, w, cot),
                        lambda: lg.laguerre_dense_fused_bwd_plain(l, x, w, cot)),
            }
            for what, (kernel, plain) in runs.items():
                outs, again, refs = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                if not isinstance(outs, tuple):
                    outs, again, refs = (outs,), (again,), (refs,)
                rel = 0.0
                for o, o2, r in zip(outs, again, refs):
                    rel = max(rel, float((o.float() - r.float()).abs().max())
                              / max(float(r.float().abs().max()), 1e-30))
                    if not torch.equal(o, o2):
                        print(f"FAIL {what} {dtype} S={s} C={c} F={f} K={k}: second launch differs")
                        bad += 1
                line = f"[{what}] {dtype} G={g} S={s} C={c} F={f} K={k}: max|err|/max|ref| {rel:.3e}"
                if not rel <= TOL[dtype]:
                    line = "FAIL " + line
                    bad += 1
                if not args.quick:
                    by_kernel = device_ms(torch, kernel)
                    parts = ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items())
                    line += (f" device {sum(by_kernel.values()):.4f} ms ({parts}); one call "
                             f"between events {median_ms(torch, kernel):.4f} ms, plain "
                             f"{median_ms(torch, plain, 5):.4f} ms")
                print(line + f" [{card}]", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
