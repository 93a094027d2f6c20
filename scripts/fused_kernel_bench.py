#!/usr/bin/env python3
"""The four Laguerre kernels (fused and terms, forward and backward) on one
CUDA card: build, registers and spills, kernel against plain version, times.

    python3 scripts/fused_kernel_bench.py [--quick] [--graph-blocks 78]
        [--only fused|terms]

Builds ``hl_hgat_tpu_torch/csrc`` with nvcc, prints what ``-Xptxas=-v``
reports for the Laguerre kernels, then for every shape and dtype holds
``laguerre_dense_fused``, ``laguerre_dense_fused_bwd``,
``laguerre_terms_dense`` and ``laguerre_terms_dense_bwd`` against their
plain versions (float32 <= 1e-4·max|ref|, bfloat16 <= 2e-2·max|ref|),
checks that a second launch gives the same bits, and times kernel and
plain version as ``chip_smoke.py`` does: the kernel's device time as ten
calls replayed from a CUDA graph (every CUDA kernel of a call counted),
and one call between two CUDA events (median of 20; for a kernel of a few
µs that is the wrapper's and the launch's time).  L is a symmetric random
matrix scaled to a spectrum of order one.  ``--quick`` checks without
timing.  A shape the wrapper refuses is reported and skipped, so the
script also times an older tree's kernels (copied into that tree's
``scripts/``).  Exits non-zero on the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import KERNEL_CALLS, graph_ms, median_ms  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (S, C, F, K): the four zinc_pyr shapes, then ragged and limit shapes, K = 10
# and 16 (beyond the 8 terms the fused backward holds at once); the terms
# kernels take (S, C, K) of each (F unused)
MAIN = [(128, 64, 64, 1), (128, 64, 64, 6), (128, 128, 128, 6), (128, 256, 256, 6)]
EXTRA = [(128, 100, 72, 3), (128, 64, 64, 8), (96, 128, 128, 6), (13, 7, 130, 1),
         (30, 33, 65, 2), (96, 300, 8, 6), (128, 512, 256, 6), (128, 40, 300, 2),
         (128, 64, 64, 10), (128, 64, 64, 16)]


def symmetric_l(np, rng, g, s):
    l32 = rng.standard_normal((g, s, s)).astype(np.float32)
    return (l32 + l32.transpose(0, 2, 1)) / (2 * np.sqrt(s))


def print_registers(cuda_build):
    """What ``-Xptxas=-v`` reported for each Laguerre kernel of the current
    build, with the threads of a terms kernel's block."""
    cuda_build.build()
    for name in ("laguerre_dense", "laguerre_dense_bwd"):
        log = cuda_build.library_path(name).with_suffix(".log")
        if not log.exists():  # an older tree's build keeps no log
            continue
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            hit = re.search(r"((?:fused|terms)_\w+?_kernel)I(f|13__nv_bfloat16)((?:Li\d+E)*)", line)
            if "Compiling entry" not in line or not hit:
                continue
            what = " ".join(x.strip().replace("ptxas info    : ", "") for x in lines[i + 1:i + 4]
                            if "registers" in x or "bytes stack" in x)
            params = re.findall(r"Li(\d+)E", hit.group(3))
            dtype = "float" if hit.group(2) == "f" else "bfloat16"
            line = f"[build] {hit.group(1)}<{', '.join([dtype] + params)}>: {what}"
            if hit.group(1).startswith("terms") and params:
                line += f"; {128 * int(params[-1])} threads"
            print(line, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="check only, no timing")
    ap.add_argument("--graph-blocks", type=int, default=78)
    ap.add_argument("--only", choices=("fused", "terms"), default=None,
                    help="check and time only these kernels")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from hl_hgat_tpu_torch import cuda_build
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    torch.backends.cuda.matmul.allow_tf32 = False
    print_registers(cuda_build)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    g = args.graph_blocks
    rng = np.random.default_rng(0)
    bad = 0
    terms_seen = set()
    for s, c, f, k in MAIN + EXTRA:
        l32 = symmetric_l(np, rng, g, s)
        x32 = rng.standard_normal((g, s, c)).astype(np.float32)
        w = torch.from_numpy(
            (rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).cuda()
        cot32 = rng.standard_normal((g, s, f)).astype(np.float32)
        dt32 = rng.standard_normal((k, g, s, c)).astype(np.float32)
        fused = args.only != "terms"
        terms = (s, c, k) not in terms_seen and args.only != "fused"
        terms_seen.add((s, c, k))
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            l, x, cot, dt = (torch.from_numpy(a).cuda().to(td) for a in (l32, x32, cot32, dt32))
            runs = {}
            if fused:
                runs["fwd"] = (lambda: lg.laguerre_dense_fused(l, x, w, b),
                               lambda: lg.laguerre_dense_fused_plain(l, x, w, b))
                runs["bwd"] = (lambda: lg.laguerre_dense_fused_bwd(l, x, w, cot),
                               lambda: lg.laguerre_dense_fused_bwd_plain(l, x, w, cot))
            if terms:
                runs["terms fwd"] = (lambda: lg.laguerre_terms_dense(l, x, k),
                                     lambda: lg.laguerre_terms_dense_plain(l, x, k))
                runs["terms bwd"] = (lambda: lg.laguerre_terms_dense_bwd(l, dt, k),
                                     lambda: lg.laguerre_terms_dense_bwd_plain(l, dt, k))
            for what, (kernel, plain) in runs.items():
                shape = f"S={s} C={c} K={k}" if what.startswith("terms") else \
                    f"S={s} C={c} F={f} K={k}"
                try:
                    outs, again = kernel(), kernel()
                except ValueError as err:  # a shape an older tree's wrapper refuses
                    print(f"[{what}] {dtype} G={g} {shape}: refused ({err}) [{card}]", flush=True)
                    continue
                refs = plain()
                torch.cuda.synchronize()
                if not isinstance(outs, tuple):
                    outs, again, refs = (outs,), (again,), (refs,)
                rel = 0.0
                for o, o2, r in zip(outs, again, refs):
                    rel = max(rel, float((o.float() - r.float()).abs().max())
                              / max(float(r.float().abs().max()), 1e-30))
                    if not torch.equal(o, o2):
                        print(f"FAIL {what} {dtype} {shape}: second launch differs")
                        bad += 1
                line = f"[{what}] {dtype} G={g} {shape}: max|err|/max|ref| {rel:.3e}"
                if not rel <= TOL[dtype]:
                    line = "FAIL " + line
                    bad += 1
                if not args.quick:
                    line += (f" device {graph_ms(torch, kernel, KERNEL_CALLS):.4f} ms;"
                             f" one call between events {median_ms(torch, kernel, 20):.4f} ms,"
                             f" plain {median_ms(torch, plain, 5):.4f} ms")
                print(line + f" [{card}]", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
