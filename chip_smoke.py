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
4. Holds each backward kernel (dx, dW, db) against its plain PyTorch
   version at the same shapes, same bounds, and times both.
5. Trains the same model on the same 384 graphs through
   ``Trainer.train_step`` (L1 loss, Adam lr 1e-3 with L2 1e-3, BN on batch
   statistics) in float32 and bfloat16 on the three routes, each from a
   copy of one seeded model: a first step, then 10 timed steps.  Per step
   the fused route must show 18 forward + 18 backward launches, the terms
   route 16 + 16, the plain route none; the loss must be finite and lower
   at the last step than at the first; every conv weight must have a
   non-zero gradient; the first step's loss and every parameter gradient
   of the fused and terms routes must agree with the plain route's
   within the bounds stated at ``EVAL_LEAF_TOL`` (BN on running
   statistics) and ``TRAIN_LEAF_TOL`` (the ill-conditioned train-mode
   gradient; loose, with the measured values beside them), and the float32
   card step with the port's CPU step on the first 16 graphs.
6. Prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
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
# Whole-model gradients, one computation against another: the worst leaf's
# error as a share of that leaf's max|ref|, and the whole gradient's error
# as a share of its norm.  Bounds are a few times what an H100 measured
# with these inputs (the measured values stand beside them).
# * BN on running statistics (the better-conditioned function): hand-kernel
#   routes against the plain route, float32 2.9e-3 per leaf and 4.0e-5 of
#   the norm, bfloat16 9.0e-2 and 9.7e-3; card against CPU on 16 graphs
#   9.7e-6 and 1.3e-6.
# * BN on batch statistics, as the training step runs it: at full depth and
#   random weights the gradient amplifies summation-order noise, whoever
#   computes it.  The plain route on the card against the plain route on
#   the CPU (printed by every run as the noise floor) differs by 3.3e-2 per
#   leaf and 3.8e-3 of the norm in float32, and by 7.1e-1 and 4.6e-1 in
#   bfloat16; the hand-kernel routes sit at the same level (float32 3.5e-2
#   and 3.4e-3).  So float32 is held to loose
#   bounds, and bfloat16 only to a cosine between the two whole gradients
#   (measured 0.898 fused, 0.9997 terms; an unrelated gradient gives 0).
EVAL_LEAF_TOL = {"float32": 1e-2, "bfloat16": 2e-1}
EVAL_NORM_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_LEAF_TOL = 1e-1
TRAIN_NORM_TOL = 2e-2
TRAIN_BF16_COSINE = 0.7
BATCH_GRAPHS = 384
TRAIN_STEPS = 10  # timed steps after the first


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
    """Kernel vs plain on the same inputs (every output, when there are
    several), then both timed; adds ``count`` launches' worth (one
    forward's or one backward's) to ``agg``."""
    outs, refs = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    err, scale = 0.0, 0.0
    for i, (out, ref) in enumerate(zip(outs, refs)):
        e = (out.float() - ref.float()).abs().max().item()
        sc = ref.float().abs().max().item()
        if not e <= TOL[dtype] * sc:
            fail(f"{tag} output {i}: max|err| {e:.3e} > {TOL[dtype]}·{sc:.3e}")
        if e >= err:
            err, scale = e, sc
    ms = median_ms(torch, kernel, 20)
    plain_ms = median_ms(torch, plain, 10)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    print(f"[kernel] {tag}: max|err| {err:.3e} (max|ref| {scale:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {max(by_bytes, by_ops):.4f} ms "
          f"({'operations' if by_ops >= by_bytes else 'bytes'}) x{count}/pass", flush=True)
    agg["err"] = max(agg["err"], err)
    agg["ms"] += count * ms
    agg["plain_ms"] += count * plain_ms
    agg["by_bytes"] += count * by_bytes
    agg["by_ops"] += count * by_ops
    agg["bound"] += count * max(by_bytes, by_ops)


def check_kernels(torch, np, lg, l_blocks, conv_shapes, rng):
    """Kernel vs plain at every distinct main-path shape, both dtypes.

    Returns per-kernel, per-dtype sums over ONE forward's (or one
    backward's) launches."""
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
        for name in lg.LAUNCHES:
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
            cot = feats(f)
            check_one(
                torch, f"laguerre_dense_fused_bwd {dtype} G={g} S={s} C={c} F={f} K={k}", dtype,
                lambda: lg.laguerre_dense_fused_bwd(l, x, w, cot),
                lambda: lg.laguerre_dense_fused_bwd_plain(l, x, w, cot),
                g * (s * s + 2 * s * c + 2 * s * f) * es + (2 * k * c * f + f) * 4,
                4 * g * s * (s * c * (k - 1) + k * c * f),
                count, summary[("laguerre_dense_fused_bwd", dtype)])
        for (k, c), count in terms_counts.items():
            x = feats(c)
            check_one(
                torch, f"laguerre_terms_dense {dtype} G={g} S={s} C={c} K={k}", dtype,
                lambda: lg.laguerre_terms_dense(l, x, k),
                lambda: lg.laguerre_terms_dense_plain(l, x, k),
                (g * s * s + g * s * c + k * g * s * c) * es,
                2 * g * s * s * c * (k - 1),
                count, summary[("laguerre_terms_dense", dtype)])
            dt = torch.stack([feats(c) for _ in range(k)])
            check_one(
                torch, f"laguerre_terms_dense_bwd {dtype} G={g} S={s} C={c} K={k}", dtype,
                lambda: lg.laguerre_terms_dense_bwd(l, dt, k),
                lambda: lg.laguerre_terms_dense_bwd_plain(l, dt, k),
                (g * s * s + g * s * c + k * g * s * c) * es,
                2 * g * s * s * c * (k - 1),
                count, summary[("laguerre_terms_dense_bwd", dtype)])
    return summary


ROUTES = {"plain": (False, False), "terms": (False, True), "fused": (True, False)}


def compare_grads(tag, got, ref, zero_grad, leaf_tol=None, norm_tol=None, cosine=None):
    """Two whole-model gradients: worst leaf error (of the leaf's
    max|ref|), error of the whole gradient (of its norm), and cosine; fails
    on the bounds that are given.  Leaves in ``zero_grad`` (a bias in front
    of a BatchNorm on batch statistics: its exact gradient is zero, what
    comes back is rounding noise) are held to the largest gradient entry of
    the model instead of their own, and so is a leaf whose reference is
    all zero."""
    gmax = max(float(r.abs().max()) for r in ref.values())
    worst, where = 0.0, ""
    dot = err2 = ref2 = got2 = 0.0
    for name, r in ref.items():
        a, r = got[name].double(), r.double()
        scale = float(r.abs().max())
        if name in zero_grad or scale == 0.0:
            scale = gmax
        rel = float((a - r).abs().max()) / scale
        if rel >= worst:
            worst, where = rel, name
        dot += float((a * r).sum())
        err2 += float(((a - r) ** 2).sum())
        ref2 += float((r * r).sum())
        got2 += float((a * a).sum())
    norm_rel = (err2 / ref2) ** 0.5
    cos = dot / (ref2 * got2) ** 0.5
    print(f"[train] {tag}: worst leaf {worst:.3e} of max|ref| ({where}), whole gradient "
          f"{norm_rel:.3e} of its norm, cosine {cos:.6f}", flush=True)
    if leaf_tol is not None and not worst <= leaf_tol:
        fail(f"{tag}: gradient of {where} is off by {worst:.3e} of max|ref| > {leaf_tol}")
    if norm_tol is not None and not norm_rel <= norm_tol:
        fail(f"{tag}: gradient is off by {norm_rel:.3e} of its norm > {norm_tol}")
    if cosine is not None and not cos >= cosine:
        fail(f"{tag}: cosine {cos:.4f} < {cosine}")


def compare_train_grads(tag, dtype, got, ref, zero_grad):
    if dtype == "float32":
        compare_grads(tag, got, ref, zero_grad, TRAIN_LEAF_TOL, TRAIN_NORM_TOL)
    else:
        compare_grads(tag, got, ref, zero_grad, cosine=TRAIN_BF16_COSINE)


def train_phase(torch, np, model32, samples, host_batch, real_edges, card):
    """A first step and TRAIN_STEPS timed steps per dtype and route through
    ``Trainer.train_step``; returns the launches summed over all of them."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, l1_loss

    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)
    none = {name: 0 for name in lg.LAUNCHES}
    per_step = {"plain": none,
                "terms": {**none, "laguerre_terms_dense": 16, "laguerre_terms_dense_bwd": 16},
                "fused": {**none, "laguerre_dense_fused": 18, "laguerre_dense_fused_bwd": 18}}
    total = dict(none)
    batch = host_batch.to("cuda")
    conv_weights = [n for n, m in model32.named_modules() if isinstance(m, conv.LaguerreConv)]
    # every conv and Linear bias but the output layer's sits in front of a BN
    zero_grad = {n for n, _ in model32.named_parameters()
                 if n.endswith(".bias") and not n.endswith("bn.bias")
                 and "MaskedBatchNorm" not in n and n != "head.out.bias"}

    def grads_of(model):
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def eval_mode_grads(model, data):
        """Loss and gradients with BN on running statistics; leaves the
        model's state as it was."""
        model.eval()
        model.zero_grad(set_to_none=True)
        loss = l1_loss(model(data).reshape(-1), data.y.reshape(-1))
        loss.backward()
        out = float(loss.detach()), grads_of(model)
        model.zero_grad(set_to_none=True)
        return out

    for dtype in ("float32", "bfloat16"):
        seed_model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        first, conditioned = {}, {}
        for route, (fused, terms) in ROUTES.items():
            conv.use_fused_dense(fused)
            conv.use_terms_kernel(terms)
            trainer = Trainer(copy.deepcopy(seed_model), cfg)
            conditioned[route] = eval_mode_grads(trainer.model, batch)
            lg.reset_launch_counts()
            losses = [trainer.train_step(batch)]
            torch.cuda.synchronize()
            if dict(lg.LAUNCHES) != per_step[route]:
                fail(f"{dtype} {route} training step launched {dict(lg.LAUNCHES)}, "
                     f"expected {per_step[route]}")
            grads = grads_of(trainer.model)
            for name in conv_weights:
                gw = grads.get(f"{name}.weight")
                if gw is None or not bool((gw != 0).any()):
                    fail(f"{dtype} {route}: {name}.weight has no gradient")
            first[route] = (float(losses[0]), grads)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                losses.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            counts = dict(lg.LAUNCHES)
            want = {k: v * (TRAIN_STEPS + 1) for k, v in per_step[route].items()}
            if counts != want:
                fail(f"{dtype} {route}: {counts} launches over {TRAIN_STEPS + 1} steps, "
                     f"expected {want}")
            for name in total:
                total[name] += counts[name]
            values = [float(x) for x in losses]
            if not all(np.isfinite(values)):
                fail(f"{dtype} {route}: non-finite loss {values}")
            if not values[-1] < values[0]:
                fail(f"{dtype} {route}: loss did not fall: {values[0]} -> {values[-1]}")
            print(f"[train] {dtype} {route}: step {step_ms:.3f} ms, "
                  f"{BATCH_GRAPHS / step_ms * 1e3:.1f} graphs/s, "
                  f"{real_edges / step_ms * 1e3:.4e} real edges/s; loss {values[0]:.5f} -> "
                  f"{values[-1]:.5f} over {len(values)} steps [{card}]", flush=True)
        ref_loss, ref_grads = first["plain"]
        # the noise floor of this gradient, printed and not bounded: the plain
        # route here against the same step on the CPU, neither through a kernel
        # of the package
        cpu_trainer = Trainer(copy.deepcopy(seed_model), cfg, device="cpu")
        cpu_trainer.train_step(host_batch)
        compare_grads(f"{dtype} plain route, card vs CPU, first step (noise floor)",
                      ref_grads,
                      {n: g.to("cuda") for n, g in grads_of(cpu_trainer.model).items()},
                      zero_grad)
        del cpu_trainer
        for route in ("fused", "terms"):
            loss, grads = first[route]
            if not abs(loss - ref_loss) <= TOL[dtype] * abs(ref_loss):
                fail(f"{dtype} {route}: first loss {loss} vs plain route {ref_loss}")
            compare_train_grads(f"{dtype} {route} vs plain route, first step", dtype,
                                grads, ref_grads, zero_grad)
            loss, grads = conditioned[route]
            if not abs(loss - conditioned["plain"][0]) <= TOL[dtype] * abs(loss):
                fail(f"{dtype} {route}: eval-mode loss {loss} vs plain {conditioned['plain'][0]}")
            compare_grads(f"{dtype} {route} vs plain route, BN on running statistics",
                          grads, conditioned["plain"][1], (), EVAL_LEAF_TOL[dtype],
                          EVAL_NORM_TOL[dtype])
    conv.use_fused_dense(True)
    conv.use_terms_kernel(False)

    # float32, default route, 16 graphs: the card against the port's CPU path
    small = collate_dense_packed(samples[:16])
    steps = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(copy.deepcopy(model32), cfg, device=device)
        data = small.to(device)
        calm = eval_mode_grads(trainer.model, data)
        loss = float(trainer.train_step(data))
        steps[device] = [(v, {n: g.cpu() for n, g in gr.items()})
                         for v, gr in (calm, (loss, grads_of(trainer.model)))]
    for i, what in enumerate(("BN on running statistics", "first training step")):
        (loss, grads), (ref_loss, ref_grads) = steps["cuda"][i], steps["cpu"][i]
        if not abs(loss - ref_loss) <= TOL["float32"] * abs(ref_loss):
            fail(f"card loss {loss} vs CPU loss {ref_loss} on 16 graphs ({what})")
        tag = f"float32 card vs CPU, 16 graphs, {what}"
        if i == 0:
            compare_grads(tag, grads, ref_grads, (), EVAL_LEAF_TOL["float32"],
                          EVAL_NORM_TOL["float32"])
        else:
            compare_train_grads(tag, "float32", grads, ref_grads, zero_grad)
    return total


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
    none = {name: 0 for name in lg.LAUNCHES}
    expect = {"plain": none,
              "terms": {**none, "laguerre_terms_dense": 16},
              "fused": {**none, "laguerre_dense_fused": 18}}
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=BATCH_GRAPHS)
        batch = pred.collate(samples)
        outs, fwd_ms = {}, {}
        for route, (fused, terms) in ROUTES.items():
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

    for name in ("laguerre_dense_fused", "laguerre_terms_dense"):
        if launches[name] == 0:
            fail(f"{name} was never launched on the serving path")

    # ---- 5. the training path ---------------------------------------------
    train_launches = train_phase(torch, np, model32, samples, host_batch, real_edges, card)
    for name, n in train_launches.items():
        if n == 0:
            fail(f"{name} was never launched on the training path")
        launches[name] += n

    # ---- 6. result lines --------------------------------------------------
    replaces = {
        "laguerre_dense_fused": "hl_hgat_tpu/ops/pallas_hodge.py:93",
        "laguerre_terms_dense": "hl_hgat_tpu/ops/pallas_hodge.py:285",
        "laguerre_dense_fused_bwd": "hl_hgat_tpu/ops/pallas_hodge.py:123",
        "laguerre_terms_dense_bwd": "hl_hgat_tpu/ops/pallas_hodge.py:293",
    }
    sources = {name: "hl_hgat_tpu_torch/csrc/laguerre_dense"
               + ("_bwd.cu" if name.endswith("_bwd") else ".cu") for name in replaces}
    for name in replaces:
        s16 = summary[(name, "bfloat16")]
        s32 = summary[(name, "float32")]
        print(f"[kernel] {name} float32 per step: kernel {s32['ms']:.4f} ms, plain "
              f"{s32['plain_ms']:.4f} ms, bound {s32['bound']:.4f} ms, max|err| "
              f"{s32['err']:.3e} [{card}]", flush=True)
        print(f"[kernel] {name} bfloat16 per step: kernel {s16['ms']:.4f} ms, plain "
              f"{s16['plain_ms']:.4f} ms, bound {s16['bound']:.4f} ms, max|err| "
              f"{s16['err']:.3e} [{card}]", flush=True)
    kernels = []
    for name, where in replaces.items():
        s32 = summary[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[name],
            "replaces": where, "launches": launches[name],
            "max_abs_err": s32["err"], "ms": s32["ms"], "plain_ms": s32["plain_ms"],
            "bound_ms": s32["bound"],
            "bound_by": "operations" if s32["by_ops"] >= s32["by_bytes"] else "bytes",
            "library_ms": None,
            "dtype": "float32", "per": "one zinc_pyr training step at batch 384",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
