#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``hl_hgat_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``hl_hgat_tpu_torch/csrc`` (nvcc, sm_90a)
   and prints the card's name and power limit.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the zinc_pyr forward gives it (the batch's real L0 blocks, random
   x/W/b), in float32 (max |err| <= 1e-4·max|ref|) and bfloat16
   (<= 2e-2·max|ref|), and times kernel and plain version (CUDA events,
   median of repeated launches).
3. Serves 384 synthetic ZINC-like graphs through ``Predictor`` with a
   full-width, seeded ``zinc_pyr`` in float32 and bfloat16, on three conv
   routes: plain torch, terms kernel + torch GEMMs, fused kernel (default).
   Outputs must be finite, agree route to route within the tolerances
   above, show 18 fused launches (fused route) or 16 terms launches (terms
   route) per forward, and the float32 card output must agree with the
   port's CPU forward on the first 16 graphs.
4. Prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   ...}`` line.

Any failed check exits non-zero before the result lines.  Needs one card;
exits non-zero without one.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 without TF32; bf16 dense
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to max|ref|
BATCH_GRAPHS = 384


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def median_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_one(torch, tag, dtype, kernel, plain, nbytes, flops, count, agg):
    """Kernel vs plain on the same inputs, then both timed; adds ``count``
    launches' worth (one forward's) to ``agg``."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= TOL[dtype] * scale:
        fail(f"{tag}: max|err| {err:.3e} > {TOL[dtype]}·{scale:.3e}")
    ms = median_ms(torch, kernel, 20)
    plain_ms = median_ms(torch, plain, 10)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    print(f"[kernel] {tag}: max|err| {err:.3e} (max|ref| {scale:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {max(by_bytes, by_ops):.4f} ms "
          f"({'operations' if by_ops >= by_bytes else 'bytes'}) x{count}/forward", flush=True)
    agg["err"] = max(agg["err"], err)
    agg["ms"] += count * ms
    agg["plain_ms"] += count * plain_ms
    agg["by_bytes"] += count * by_bytes
    agg["by_ops"] += count * by_ops
    agg["bound"] += count * max(by_bytes, by_ops)


def check_kernels(torch, np, lg, l_blocks, conv_shapes, rng):
    """Kernel vs plain at every distinct main-path shape, both dtypes.

    Returns per-kernel, per-dtype sums over ONE forward's launches."""
    g, s = l_blocks.shape[:2]
    fused_counts, terms_counts = {}, {}
    for k, c, f in conv_shapes:
        fused_counts[(k, c, f)] = fused_counts.get((k, c, f), 0) + 1
        if k > 1:
            terms_counts[(k, c)] = terms_counts.get((k, c), 0) + 1
    fused_counts[(3, 100, 72)] = 0  # ragged C and F, checked but not on the path
    summary = {}
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        es = torch.tensor([], dtype=td).element_size()
        l = l_blocks.to(td)
        for name in ("laguerre_dense_fused", "laguerre_terms_dense"):
            summary[(name, dtype)] = dict(ms=0.0, plain_ms=0.0, by_bytes=0.0,
                                          by_ops=0.0, bound=0.0, err=0.0)

        def feats(c):
            return torch.from_numpy(
                rng.standard_normal((g, s, c)).astype(np.float32)).cuda().to(td)

        for (k, c, f), count in fused_counts.items():
            x = feats(c)
            w = torch.from_numpy(
                rng.uniform(-1, 1, (k, c, f)).astype(np.float32) * np.sqrt(6.0 / (c + f))).cuda()
            b = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).cuda()
            check_one(
                torch, f"laguerre_dense_fused {dtype} G={g} S={s} C={c} F={f} K={k}", dtype,
                lambda: lg.laguerre_dense_fused(l, x, w, b),
                lambda: lg.laguerre_dense_fused_plain(l, x, w, b),
                (g * s * s + g * s * c + g * s * f) * es + (k * c * f + f) * 4,
                2 * g * s * (s * c * (k - 1) + k * c * f),
                count, summary[("laguerre_dense_fused", dtype)])
        for (k, c), count in terms_counts.items():
            x = feats(c)
            check_one(
                torch, f"laguerre_terms_dense {dtype} G={g} S={s} C={c} K={k}", dtype,
                lambda: lg.laguerre_terms_dense(l, x, k),
                lambda: lg.laguerre_terms_dense_plain(l, x, k),
                (g * s * s + g * s * c + k * g * s * c) * es,
                2 * g * s * s * c * (k - 1),
                count, summary[("laguerre_terms_dense", dtype)])
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    import numpy as np

    from hl_hgat_tpu_torch import cuda_build
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg
    from hl_hgat_tpu_torch.serving import Predictor

    # f32 means f32: the JAX reference runs Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # ---- data -------------------------------------------------------------
    t0 = time.perf_counter()
    samples = zinc_like_samples(np.random.default_rng(0), BATCH_GRAPHS)
    host_batch = collate_dense_packed(samples)
    real_edges = int(host_batch.level0.edge_mask.sum())
    g = host_batch.x_t.shape[0]
    print(f"[data] {BATCH_GRAPHS} graphs, {real_edges} real edges, {g} blocks of "
          f"{host_batch.x_t.shape[1]} ({time.perf_counter() - t0:.2f} s host)", flush=True)

    # ---- 2. kernels vs plain at main-path shapes --------------------------
    model32, _ = presets.zinc_pyr(seed=0)
    conv_shapes = [tuple(m.weight.shape) for m in model32.modules()
                   if isinstance(m, conv.LaguerreConv)]
    if len(conv_shapes) != 18:
        fail(f"zinc_pyr has {len(conv_shapes)} Laguerre convs, expected 18")
    l_blocks = torch.as_tensor(host_batch.level0.l0).cuda()
    summary = check_kernels(torch, np, lg, l_blocks, conv_shapes, np.random.default_rng(1))

    # ---- 3. the serving path ----------------------------------------------
    launches = {name: 0 for name in lg.LAUNCHES}
    routes = {"plain": (False, False), "terms": (False, True), "fused": (True, False)}
    expect = {"plain": {"laguerre_dense_fused": 0, "laguerre_terms_dense": 0},
              "terms": {"laguerre_dense_fused": 0, "laguerre_terms_dense": 16},
              "fused": {"laguerre_dense_fused": 18, "laguerre_terms_dense": 0}}
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=BATCH_GRAPHS)
        batch = pred.collate(samples)
        outs, fwd_ms = {}, {}
        for route, (fused, terms) in routes.items():
            conv.use_fused_dense(fused)
            conv.use_terms_kernel(terms)
            lg.reset_launch_counts()
            # the entry point a user calls: samples in, [N, 1] out
            outs[route] = pred(samples)
            counts = dict(lg.LAUNCHES)
            if counts != expect[route]:
                fail(f"{dtype} {route} route launched {counts}, expected {expect[route]}")
            for name in launches:
                launches[name] += counts[name]
            out = outs[route]
            if out.shape != (BATCH_GRAPHS, 1) or not np.isfinite(out).all():
                fail(f"{dtype} {route}: output shape {out.shape} or non-finite values")
            fwd_ms[route] = median_ms(torch, lambda: pred.forward(batch), 10)
            t0 = time.perf_counter()
            pred(samples)
            e2e = (time.perf_counter() - t0) * 1e3
            print(f"[serve] {dtype} {route}: forward {fwd_ms[route]:.3f} ms, "
                  f"{BATCH_GRAPHS / fwd_ms[route] * 1e3:.1f} graphs/s, "
                  f"{real_edges / fwd_ms[route] * 1e3:.4e} real edges/s; "
                  f"Predictor call incl. host collate {e2e:.1f} ms [{card}]", flush=True)
        conv.use_fused_dense(True)
        conv.use_terms_kernel(False)
        ref = outs["plain"]
        scale = float(np.abs(ref).max())
        for route in ("fused", "terms"):
            err = float(np.abs(outs[route] - ref).max())
            print(f"[serve] {dtype} {route} vs plain route: max|err| {err:.3e} "
                  f"(max|ref| {scale:.3e})", flush=True)
            if not err <= TOL[dtype] * scale:
                fail(f"{dtype} {route} route disagrees with the plain route")
        if dtype == "float32":
            cpu_model = copy.deepcopy(model).to("cpu")
            cpu_out = Predictor(cpu_model, batch_size=16, device="cpu")(samples[:16])
            err = float(np.abs(outs["fused"][:16] - cpu_out).max())
            cscale = float(np.abs(cpu_out).max())
            print(f"[serve] float32 card vs CPU forward (16 graphs): max|err| {err:.3e} "
                  f"(max|ref| {cscale:.3e})", flush=True)
            if not err <= TOL[dtype] * cscale:
                fail("card output disagrees with the CPU forward")

    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched on the serving path")

    # ---- 4. result lines --------------------------------------------------
    replaces = {
        "laguerre_dense_fused": "hl_hgat_tpu/ops/pallas_hodge.py:93",
        "laguerre_terms_dense": "hl_hgat_tpu/ops/pallas_hodge.py:285",
    }
    for name in replaces:
        s16 = summary[(name, "bfloat16")]
        print(f"[kernel] {name} bfloat16 per forward: kernel {s16['ms']:.4f} ms, plain "
              f"{s16['plain_ms']:.4f} ms, bound {s16['bound']:.4f} ms, max|err| "
              f"{s16['err']:.3e} [{card}]", flush=True)
    kernels = []
    for name, where in replaces.items():
        s32 = summary[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "hl_hgat_tpu_torch/csrc/laguerre_dense.cu",
            "replaces": where, "launches": launches[name],
            "max_abs_err": s32["err"], "ms": s32["ms"], "plain_ms": s32["plain_ms"],
            "bound_ms": s32["bound"],
            "bound_by": "operations" if s32["by_ops"] >= s32["by_bytes"] else "bytes",
            "library_ms": None,
            "dtype": "float32", "per": "one zinc_pyr forward at batch 384",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
