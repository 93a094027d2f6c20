#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``hl_hgat_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [resident|band|ell]   # the kernel phases only

1. Builds the CUDA kernels from ``hl_hgat_tpu_torch/csrc`` (nvcc, sm_90a)
   and, at the same time, the host library ``csrc/hlhgat_native.cpp`` (g++;
   a ``[native]`` line with its build seconds), prints the card's name and
   power limit, and reads the three Laguerre
   libraries with ``cuobjdump -sass``: every Laguerre kernel, fused and
   terms, forward and backward, and every product kernel of the band
   library, must hold tensor-core opcodes (HMMA / HGMMA), in float32
   (3xTF32) and in bfloat16.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the zinc_pyr forward gives it (the batch's real L0 blocks, random
   x/W/b) and, off the path, at a ragged shape, at K = 8, at S = 96 and at
   K = 10 (beyond the 8 terms the fused backward holds at once), in
   float32 (max |err| <= 1e-4·max|ref|) and bfloat16 (<= 2e-2·max|ref|); a
   second launch of a Laguerre kernel must give the same bits; times the
   kernel as device time (ten calls replayed as one CUDA graph, every
   kernel of the call counted) and the plain version between CUDA events.
   Every ``[kernel]`` line ends with a short hash of the kernel's output
   bytes (``bits``), so two trees run in one call can be compared bit for
   bit.
2b. Holds the four Laguerre kernels on blocks over 128 rows (the band
   kernels of ``csrc/laguerre_band.cu``) against their plain versions,
   forward and backward, both dtypes, same bounds, a second launch
   bit-equal: every distinct conv shape over 128 rows of the pooled path
   below (its 256-row L1 blocks; coarse-level blocks too where they exceed
   128 rows), counted per pass, and off the path the same graphs' 512-row
   L1 blocks at K = 4, C = F = 64 and 128.
3. Serves 384 synthetic ZINC-like graphs through ``Predictor`` (loader-fed:
   ``BucketedLoader``, derived transfer, inflated on the card; the [serve]
   line gives the loader's block count beside the packing's) with a
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
6. Holds the ELL SpMM kernel (forward, and ``dx`` through autograd)
   against its plain version at the flat path's shapes: L0 and L1 of the
   384-graph batch at F = 64, 128, 256, a ragged F = 37, a 3-D x, and L0
   and L1 of the node-classification batch; float32 (max |err| <=
   1e-5·max|ref|) and bfloat16 (<= 2e-2·max|ref|), a second launch
   bit-equal; times kernel, plain version and ``torch.sparse.mm`` on a CSR
   tensor of the same operator (a yardstick, used nowhere in the package)
   as device time (CUDA graph replay; the library call from a
   ``torch.profiler`` trace); each line hashes the output and dx bytes.
7. Drives the flat (COO/ELL) layout at full width through ``Trainer``:
   ``zinc_pyr`` on the same 384 graphs (eval forward, a first step and 10
   timed steps on the ELL-kernel route, the plain gather route and the COO
   route, float32 and bfloat16: 80 forward + 80 backward kernel launches a
   step on the kernel route, none on the others; falling loss; non-zero
   conv gradients; routes agree within ``FLAT_TOL``; the flat predictions
   equal the packed path's within 1e-4), ``pascalvoc_node`` on 32
   superpixel-like graphs (36 + 36 launches a step, logits exactly 0 on
   padded nodes) and ``pcqm_link`` on 256 graphs with 4 x (1 + 8) query
   pairs each (MRR from ``Trainer.evaluate``, 5 steps, 36 + 33 launches:
   the link head never reads the last edge conv, so its three mat-vecs
   have no backward).
3b. Serves the same 384 graphs with ``Predictor(edge_cap=256)`` (256-row
   L1 blocks, the band kernels) in both dtypes, 18 fused launches a
   forward, predictions equal to the 128-row packing's within the kernel
   tolerances; then trains zinc_pyr ZINC_WIDE_STEPS steps at edge_cap 128
   and at 256 (18 + 18 launches a step), the first losses equal.
8. The pooled path: ``cifar10sp_attpool`` at full width (channels (2,2,2),
   filters (64,128,256), K=4, MLP (256,), 10 classes) on POOLED_GRAPHS
   synthetic cifar10sp graphs (``data/synthetic.pooled_like_samples``, one
   coarsened level) packed with node_cap 128, edge_cap 256.  In each dtype
   it serves them through ``Predictor`` (14 fused launches a forward;
   fused route against the plain route, float32 card against the CPU on
   16 graphs), holds the gradients with BN on running statistics against
   the plain route, and trains POOLED_STEPS steps through ``Trainer``
   (classification task; 14 + 14 launches a step, finite losses, non-zero
   conv gradients); forward and step ms with the device's busy share from
   a ``torch.profiler`` window.  Then one eval forward of the flat layout
   on the ELL kernel (36 launches), held against the packed predictions.
9. The large-graph layout and the TSP edge-level model at the full width
   of the TSP-500 configuration (``tsp_pyr``: channels (2,2,2), filters
   (64,128,256), K=2, MLP (256,)): TSP_GRAPHS k-NN graphs of 50-500 nodes
   (``data/synthetic.tsp_like_samples``, seed 0) packed at (128, 512) rows
   into spanning blocks (a ``[tsp]`` line: blocks, spill nnz, bands, real
   nodes and edges, host build and collate times).  In each dtype: one
   warm-up and TSP_STEPS timed ``edge_binary`` steps, TSP_STEPS with
   ``tsp_aug_prob=0.75``, one ``evaluate`` (finite losses, F1 in [0, 1],
   non-zero conv gradients, no hand-kernel launch: the banded operators take
   the plain recurrence, as in the JAX package); the banded eval forward
   against the flat layout's (ELL kernel) edge by edge (float32 rtol 1e-3 /
   atol 1e-4) and one train-mode step's gradients (``compare_train_grads``);
   the augmentation mask (the same twice for one seed, tour edges kept,
   logits 0 where dropped); then TSP_SERVE_GRAPHS graphs of 50-80 nodes
   served through ``Predictor(edge_level=True)`` (fused kernel on 128-row L0
   and 512-row L1 blocks, against the plain route; float32 against the CPU
   on 8 graphs).  Step, forward and Predictor times with the busy share and
   the top device operations from a ``torch.profiler`` window.
10. The brain family on the shared-skeleton layout (one operator a level,
   [1, S, S], broadcast over the subjects), at the JAX CLI's brain recipe:
   the Shen-268 pyramid rebuilt from the skeleton of
   ``tests/golden/reference/model_hgat_attpool.npz`` by the port's MLGC
   (268/8997 → 139/2676 → 75/800, equal to the fixture's assignments and
   coarse edges; a ``[brain]`` line with the host build and collate
   times), BRAIN_BATCH subjects of ``synthetic_fmri_series`` (seed 0, T =
   128).  Kernels 2 and 4 on the folded level-0 and level-1 L1 shapes
   ([1, S, 16·C]) against their plain versions, both dtypes, bits equal on
   relaunch; ``hgat_attpool`` ((2,2,2), (32,64,128), K = 4, two pools, MLP
   (64,)) served for BRAIN_SUBJECTS subjects through ``BrainPredictor``
   per dtype (14 terms launches a forward, none fused), against the plain
   route (float32 TOL, bfloat16 BRAIN_BF16_TOL of max|ref| per output) and,
   in float32, against the flat layout on the ELL kernel (rtol 2e-4, atol
   2e-5: the JAX package's shared-vs-flat test); trained one warm-up step
   (cuDNN's autotuner picks Inception1D's algorithms) and BRAIN_STEPS
   ``Trainer(task="brain")`` steps per dtype (14 terms + 13 terms-backward
   launches a step); forward and step ms with the busy share, peak device
   memory and the top device operations, beside the same forward and steps
   on the plain route; ``abcd_attpool`` at its preset widths served once
   per dtype.
11. The data pipeline at the JAX CLI's zinc recipe (``[data]`` lines):
   ZINC-format raw splits of ZINC_SPLITS seeded molecules of 9-38 atoms
   written to a temporary directory, ``load_samples("zinc", ...)``: the
   train split parsed, the val split parsed and cached, then read from the
   cache (equal arrays); ``BucketedLoader`` (batch 128, packed, caps 128)
   for each transfer, dense, compact and derived: the first batch moved to
   the card and inflated there equal to the native dense batch (derived:
   L0/L1 within 1 ulp, the rest bit-equal), the native collate equal to
   ``collate_dense_packed``, host collate ms and bytes a batch over
   DATA_COLLATE_BATCHES batches, inflate ms; bfloat16 features bit-equal
   to the float32 batch cast on the card; full-width ``zinc_pyr`` through
   ``Trainer.fit`` for DATA_EPOCHS epochs per dtype with the CLI's zinc
   settings (PE flips, prefetch 2; 18 + 18 fused launches a step, 18 an
   eval forward; finite, falling losses; finite val MAE; epoch and
   train-epoch seconds, busy share), one more float32 train epoch with
   prefetch 0, a step with flips on against the
   step on a batch pre-flipped by the same draws (bit-equal when two equal
   steps are); the val split through the coo loader on the ELL kernel
   (80 launches a forward) against the packed predictions.
12. Checkpoint and resume at the JAX CLI's zinc recipe (``[ckpt]`` lines,
   within CKPT_PHASE_S): ``run.main`` trains full-width ``zinc_pyr`` on
   512 synthetic graphs 2 epochs with ``--ckpt_every 1``, resumes to 3
   (``resumed from epoch 2``) and runs 3 straight (18 + 18 fused launches
   a step, 18 an eval forward; epoch 3's losses within RESUME_RTOL); the
   full state's size, load and save seconds; ``--test 1`` on the shipped
   ``weights/torch/zinc_fold0`` against the JAX CLI's loss and metric in
   its ``jax_reference.npz`` (CLI_RTOL); ``Predictor.from_checkpoint``
   serving those weights to 384 graphs per dtype against the JAX forward
   (TOL; 18 fused launches), with the Predictor call ms for the dense and
   derived transfers; ``import_hgcnn`` of the ``model_zinc_pyr`` fixture
   on the card against its reference output (TOL).
13. Prints one ``{"kernels": [...]}`` line (five kernels; launches summed
   over every phase's main-path runs) and, last, the ``{"ok": true, ...}``
   line.

Any failed check exits non-zero before the result lines.  Needs one card;
exits non-zero without one.

``--kernels-only`` runs the build and the kernel checks alone (phases 2, 4
and 6, with the card's line; ``--kernels-only ell`` phase 6 alone) and
prints no result line.  Copied into an older tree's checkout, it times and
hashes that tree's kernels on the same inputs, so two trees can be
compared in one call (parent, change, change, parent); a shape that the
older tree's wrappers refuse fails the run there, so give such a tree only
the phases it takes.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# bf16 dense on the tensor cores; float32-accurate work at its fastest is
# three TF32 passes (the fused kernels' 3xTF32): 495 / 3 TFLOP/s, above the
# 67 TFLOP/s of the CUDA cores, so no float32 row can read under its bound
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# the kernels that must hold tensor-core opcodes, in both dtypes
MMA_KERNELS = {"laguerre_dense": ("fused_fwd_mma_kernel", "terms_fwd_mma_kernel"),
               "laguerre_dense_bwd": ("fused_bwd_dx_mma_kernel", "fused_bwd_dw_mma_kernel",
                                      "terms_bwd_mma_kernel"),
               "laguerre_band": ("band_step_kernel", "band_out_kernel", "band_bar_kernel",
                                 "band_dw_kernel")}
KERNEL_CALLS = 10  # calls per CUDA graph when a Laguerre kernel is timed
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
# ELL SpMM kernel against its plain version: same f32 products, summed over
# at most a few dozen slots in another order; bf16 rounds that sum once.
ELL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ELL_INNER = 20  # calls per timing of the ELL kernel, which takes less than a launch's latency
# Flat-layout eval outputs, one mat-vec route against another (share of
# max|ref|).  float32 routes differ in summation order (the COO scatter
# sums with atomics); in bfloat16 the COO route also rounds every product to
# bf16 before the f32 sum, which the two ELL routes do not.
FLAT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FLAT_BF16_COSINE = 0.9  # bf16 whole-gradient agreement between flat routes, BN on running stats
CROSS_LAYOUT_ATOL = 1e-4  # flat against packed predictions, float32
NODE_GRAPHS, LINK_GRAPHS, LINK_STEPS = 32, 256, 5
# the pooled path: cifar10sp_attpool on the JAX CLI's synthetic cifar10sp
# graphs, packed at edge_cap 256; zinc_pyr's training steps at edge_cap 256
POOLED_GRAPHS, POOLED_STEPS, ZINC_WIDE_STEPS = 128, 4, 3
# the TSP-500 configuration (benchmarks/tsp_bench.py:79-80,131-134): k-NN
# graphs of 50-500 nodes packed at (128, 512) rows, the "banded 32" batch
TSP_GRAPHS, TSP_SERVE_GRAPHS, TSP_STEPS = 32, 64, 3
TSP_CAPS = dict(node_cap=128, edge_cap=512)
TSP_MODEL = dict(channels=(2, 2, 2), filters=(64, 128, 256), k=2, dropout=0.0,
                 mlp_channels=(256,))
# the brain workflow at the JAX CLI's recipe (hl_hgat_tpu/run.py:167-170, 411-431):
# hgat_attpool on the Shen-268 pyramid of the reference fixture, batch 16,
# T = 128, lr = l2 = 1e-4; abcd_attpool at its preset widths
BRAIN_FIXTURE = "tests/golden/reference/model_hgat_attpool.npz"
BRAIN_SUBJECTS, BRAIN_BATCH, BRAIN_T, BRAIN_STEPS = 32, 16, 128, 3
BRAIN_MODEL = dict(channels=(2, 2, 2), filters=(32, 64, 128), k=4, mlp_channels=(64,),
                   pool_num=2)
ABCD_MODEL = dict(channels=(2, 2, 2), filters=(64, 128, 256), k=2, pool_num=1)
# bfloat16 shared forward, terms kernel against the plain route (share of
# max|ref| per output; 4.7e-4 measured at most on an H100); float32 keeps TOL
BRAIN_BF16_TOL = 5e-3
# the data pipeline at the JAX CLI's zinc recipe: ZINC-format raw splits of
# the ZINC-12k subset's train and val sizes, molecules of 9-38 atoms;
# load_samples' keig for zinc (hl_hgat_tpu/run.py:617) and the CLI's batch,
# caps, transfer and trainer settings (run.py:37, 89, 95, 197-198, 575-594)
ZINC_SPLITS = {"train": 10_000, "val": 1_000}
ZINC_ATOMS = (9, 38)
ZINC_LOAD_KEIG = 15 + 1
DATA_LOADER = dict(batch_size=128, layout="dense_packed", node_cap=128, edge_cap=128)
DATA_TRAINER = dict(task="regression", denorm=2.0109, save_gate=0.4, pe_flip_node_static=1,
                    pe_flip_edge_static=1, prefetch=2)
DATA_EPOCHS = 2
DATA_COLLATE_BATCHES = 8  # batches a transfer's host collate is timed over
DERIVED_RTOL = 3e-7  # derived L0/L1 against the host-built values: 1 ulp
# phase 12: the CLI's zinc recipe (hl_hgat_tpu/run.py defaults: zinc_pyr
# (2,3,3), (64,128,256), K=6, keig 15, MLP (256,256), batch 128, layout auto,
# derived transfer) trained with checkpoints, resumed and compared; the
# shipped weights/zinc_fold0 converted by scripts/convert_jax_checkpoint.py
# (trained with --keig 4: its embedding table is [28, 60]) tested through
# the CLI and served, against the JAX numbers in its jax_reference.npz
CKPT_CLI = ["--benchmark", "zinc", "--synthetic", "--n_synthetic", "512", "--fold", "0",
            "--ckpt_every", "1"]
SHIPPED = "weights/torch/zinc_fold0"
SHIPPED_KEIG = 4
SHIPPED_TEST = ["--benchmark", "zinc", "--keig", str(SHIPPED_KEIG), "--synthetic",
                "--n_synthetic", "128", "--fold", "0", "--test", "1", "--save_dir",
                "weights/torch"]
IMPORT_FIXTURE = "tests/golden/reference/model_zinc_pyr.npz"
# epoch 3 resumed against straight: index_add_'s atomics on the card leave
# the summation order free, so the bound is not bit equality
RESUME_RTOL = 1e-5
CLI_RTOL = 1e-4  # --test loss and metric against the JAX CLI's
CKPT_PHASE_S = 60


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bits(torch, *tensors) -> str:
    """A short hash of the tensors' bytes: equal hashes, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def median_ms(torch, fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls, per call.  One call between two events cannot resolve less than
    the launch latency (about 0.03 ms here); a kernel of a few µs is timed
    with ``inner`` > 1, its input then coming from L2 as it does for the
    model, where the producer has just written it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls: int) -> float:
    """Device time of one call of ``fn``: the kernels of ``calls`` calls
    traced with ``torch.profiler`` and summed.  For work of a few µs, where
    a host clock or an event pair measures the wrapper and the launch."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                total_us += getattr(evt, "self_device_time_total", None) or getattr(
                    evt, "self_cuda_time_total", 0.0)
        if total_us > 0:
            return total_us / 1e3 / calls
    fail("the profiler recorded no device time in three traces")


def graph_ms(torch, fn, calls: int, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured into one
    CUDA graph, the graph replayed between two events, median of ``reps``
    replays over ``calls``.  The replay launches the kernels back to back with
    no wrapper and no launch from the host in between, so a kernel of a few
    µs is timed and not its launch (every kernel of the call counts: a cast,
    a fill, a reduce).  ``device_ms`` would do, but a process that opens much
    more than a hundred ``torch.profiler`` traces starts to lose events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(torch, graph.replay, reps) / calls


def check_one(torch, tag, dtype, kernel, plain, nbytes, flops, count, agg, same_bits=False):
    """Kernel vs plain on the same inputs (every output, when there are
    several), then both timed; adds ``count`` launches' worth (one
    forward's or one backward's) to ``agg``.  ``same_bits``: a second
    launch must reproduce the first bit for bit."""
    outs, refs = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, refs = (outs,), (refs,)
    if same_bits:
        again = kernel()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            fail(f"{tag}: a second launch gave other bits")
    err, scale = 0.0, 0.0
    for i, (out, ref) in enumerate(zip(outs, refs)):
        e = (out.float() - ref.float()).abs().max().item()
        sc = ref.float().abs().max().item()
        if not e <= TOL[dtype] * sc:
            fail(f"{tag} output {i}: max|err| {e:.3e} > {TOL[dtype]}·{sc:.3e}")
        if e >= err:
            err, scale = e, sc
    ms = graph_ms(torch, kernel, KERNEL_CALLS)
    plain_ms = median_ms(torch, plain, 10)
    call_ms = median_ms(torch, kernel, 10)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    print(f"[kernel] {tag}: max|err| {err:.3e} (max|ref| {scale:.3e}) "
          f"kernel {ms:.4f} ms (a call through the wrapper {call_ms:.4f} ms) plain "
          f"{plain_ms:.4f} ms bound {max(by_bytes, by_ops):.4f} ms "
          f"({'operations' if by_ops >= by_bytes else 'bytes'}) x{count}/pass "
          f"bits {bits(torch, *outs)}", flush=True)
    agg["err"] = max(agg["err"], err)
    agg["ms"] += count * ms
    agg["plain_ms"] += count * plain_ms
    agg["by_bytes"] += count * by_bytes
    agg["by_ops"] += count * by_ops
    agg["bound"] += count * max(by_bytes, by_ops)


def check_fused_pair(torch, lg, dtype, label, lb, x, w, b, cot, count, summary):
    """The fused forward and backward against their plain versions on one
    case; ``label`` names the case after the dtype."""
    g, sb, c = x.shape
    k, _, f = w.shape
    es = x.element_size()
    shape = f"{dtype} {label}G={g} S={sb} C={c} F={f} K={k}"
    check_one(
        torch, f"laguerre_dense_fused {shape}", dtype,
        lambda: lg.laguerre_dense_fused(lb, x, w, b),
        lambda: lg.laguerre_dense_fused_plain(lb, x, w, b),
        (g * sb * sb + g * sb * c + g * sb * f) * es + (k * c * f + f) * 4,
        2 * g * sb * (sb * c * (k - 1) + k * c * f),
        count, summary[("laguerre_dense_fused", dtype)], same_bits=True)
    check_one(
        torch, f"laguerre_dense_fused_bwd {shape}", dtype,
        lambda: lg.laguerre_dense_fused_bwd(lb, x, w, cot),
        lambda: lg.laguerre_dense_fused_bwd_plain(lb, x, w, cot),
        g * (sb * sb + 2 * sb * c + 2 * sb * f) * es + (2 * k * c * f + f) * 4,
        4 * g * sb * (sb * c * (k - 1) + k * c * f),
        count, summary[("laguerre_dense_fused_bwd", dtype)], same_bits=True)


def check_terms_pair(torch, lg, dtype, label, lb, x, dt, count, summary):
    """The terms forward and backward against their plain versions."""
    g, sb, c = x.shape
    k = dt.shape[0]
    nbytes = (g * sb * sb + g * sb * c + k * g * sb * c) * x.element_size()
    flops = 2 * g * sb * sb * c * (k - 1)
    shape = f"{dtype} {label}G={g} S={sb} C={c} K={k}"
    check_one(
        torch, f"laguerre_terms_dense {shape}", dtype,
        lambda: lg.laguerre_terms_dense(lb, x, k),
        lambda: lg.laguerre_terms_dense_plain(lb, x, k),
        nbytes, flops, count, summary[("laguerre_terms_dense", dtype)], same_bits=True)
    check_one(
        torch, f"laguerre_terms_dense_bwd {shape}", dtype,
        lambda: lg.laguerre_terms_dense_bwd(lb, dt, k),
        lambda: lg.laguerre_terms_dense_bwd_plain(lb, dt, k),
        nbytes, flops, count, summary[("laguerre_terms_dense_bwd", dtype)], same_bits=True)


def empty_summary(lg):
    return {(name, dtype): dict(ms=0.0, plain_ms=0.0, by_bytes=0.0, by_ops=0.0, bound=0.0,
                                err=0.0)
            for name in lg.LAUNCHES for dtype in ("float32", "bfloat16")}


def check_kernels(torch, np, lg, l_blocks, conv_shapes, seed):
    """Kernel vs plain at every distinct main-path shape, both dtypes.  Each
    case draws its inputs from its own generator, seeded by ``seed`` and its
    shape, so a tree given only some of the cases (an older tree's limits)
    hashes those as the full run does.

    Returns per-kernel, per-dtype sums over ONE forward's (or one
    backward's) launches."""
    g, s = l_blocks.shape[:2]
    fused_counts, terms_counts = {}, {}
    for k, c, f in conv_shapes:
        fused_counts[(k, c, f)] = fused_counts.get((k, c, f), 0) + 1
        if k > 1:
            terms_counts[(k, c)] = terms_counts.get((k, c), 0) + 1
    # checked but not on the path (count 0): ragged C and F, K = 8, a block
    # size under 128 (the leading 96 x 96 of L0) and K = 10, beyond the 8
    # terms the fused backward holds at once (the terms kernels too)
    off_path = [(s, 3, 100, 72), (s, 8, 64, 64), (96, 6, 128, 128), (s, 10, 64, 64)]
    terms_off_path = [(s, 3, 100), (s, 8, 64), (96, 6, 128), (s, 10, 64)]
    summary = empty_summary(lg)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        l = l_blocks.to(td)

        def feats(rng, c, rows=s):
            return torch.from_numpy(
                rng.standard_normal((g, rows, c)).astype(np.float32)).cuda().to(td)

        cases = [(s, *shape, count) for shape, count in fused_counts.items()]
        for sb, k, c, f, count in cases + [(*shape, 0) for shape in off_path]:
            lb = l if sb == s else l[:, :sb, :sb].contiguous()
            rng = np.random.default_rng([seed, sb, k, c, f])
            x = feats(rng, c, sb)
            w = torch.from_numpy((rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))
                                  ).astype(np.float32)).cuda()
            b = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).cuda()
            cot = feats(rng, f, sb)
            check_fused_pair(torch, lg, dtype, "", lb, x, w, b, cot, count, summary)
        terms_cases = [(s, k, c, count) for (k, c), count in terms_counts.items()]
        for sb, k, c, count in terms_cases + [(*shape, 0) for shape in terms_off_path]:
            lb = l if sb == s else l[:, :sb, :sb].contiguous()
            rng = np.random.default_rng([seed, sb, k, c])
            x = feats(rng, c, sb)
            dt = torch.stack([feats(rng, c, sb) for _ in range(k)])
            check_terms_pair(torch, lg, dtype, "", lb, x, dt, count, summary)
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


def csr_of(torch, coo):
    """The operator of a CooMatrix as a float32 CSR tensor (the library
    yardstick's input; built outside the timed region)."""
    idx = torch.stack([coo.rows.long(), coo.cols.long()])
    return torch.sparse_coo_tensor(idx, coo.vals.float(), coo.shape).coalesce().to_sparse_csr()


def check_ell(torch, np, ell, cases, rng, card):
    """The ELL SpMM kernel against its plain version, forward and dx, at
    every case ``(tag, CooMatrix on the card, trailing feature shape,
    launches per pass)``, both dtypes; a second launch must give the same
    bits.  Times kernel and plain version as device time (``graph_ms``: the
    kernel takes a few µs, less than its wrapper and launch take on the
    host), ``torch.sparse.mm`` the same way from a profiler trace
    (``device_ms``), and one call through the wrapper as ``ELL_INNER``
    back-to-back calls between two events.

    Returns per dtype the sums over one flat zinc_pyr training step's
    launches (each counted shape runs once forward and once, on the
    cotangent, backward)."""
    summary = {}
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, by_bytes=0.0, by_ops=0.0,
                   bound=0.0, err=0.0)
        for tag, coo, feat, count in cases:
            n, w = coo.ell_cols.shape
            cols, vals = coo.ell_cols, coo.ell_vals.to(td)
            x = torch.from_numpy(rng.standard_normal((n,) + feat).astype(np.float32)).cuda().to(td)
            cot = torch.from_numpy(rng.standard_normal((n,) + feat).astype(np.float32)).cuda().to(td)
            out, ref = ell.spmm_ell(cols, vals, x), ell.spmm_ell_plain(cols, vals, x)
            # dx through autograd, against the plain version of the same
            # function: the operator is symmetric, so dx = A · cotangent
            xk = x.clone().requires_grad_()
            ell.spmm_ell_symmetric(cols, vals, xk).backward(cot)
            ref_dx = ell.spmm_ell_plain(cols, vals, cot)
            torch.cuda.synchronize()
            name = f"spmm_ell {dtype} {tag} N={n} W={w} F={'x'.join(map(str, feat))}"
            err = 0.0
            for what, a, r in (("out", out, ref), ("dx", xk.grad, ref_dx)):
                e = (a.float() - r.float()).abs().max().item()
                sc = r.float().abs().max().item()
                if not e <= ELL_TOL[dtype] * sc:
                    fail(f"{name} {what}: max|err| {e:.3e} > {ELL_TOL[dtype]}·{sc:.3e}")
                err = max(err, e)
            if not (torch.equal(out, ell.spmm_ell(cols, vals, x))
                    and torch.equal(xk.grad, ell.spmm_ell(cols, vals, cot))):
                fail(f"{name}: a second launch gave other bits")
            call_ms = median_ms(torch, lambda: ell.spmm_ell(cols, vals, x), 5, ELL_INNER)
            ms = graph_ms(torch, lambda: ell.spmm_ell(cols, vals, x), ELL_INNER)
            plain_ms = graph_ms(torch, lambda: ell.spmm_ell_plain(cols, vals, x), ELL_INNER)
            x2 = x.reshape(n, -1)
            try:
                csr = csr_of(torch, coo).to(td)
                lib_ms = device_ms(torch, lambda: torch.sparse.mm(csr, x2), ELL_INNER)
                lib_err = (torch.sparse.mm(csr, x2).float() - ref.reshape(n, -1).float()
                           ).abs().max().item()
                if not lib_err <= 5 * ELL_TOL[dtype] * ref.float().abs().max().item():
                    fail(f"{name}: torch.sparse.mm computes another function ({lib_err:.3e})")
            except RuntimeError as err_lib:  # this torch has no CSR product in this dtype
                print(f"[kernel] {name}: torch.sparse.mm refused ({str(err_lib)[:80]})", flush=True)
                lib_ms = None
            f = x2.shape[1]
            nbytes = cols.numel() * 4 + vals.numel() * vals.element_size() \
                + 2 * x.numel() * x.element_size()
            flops = 2 * int((coo.ell_vals != 0).sum()) * f  # the non-zeros of this operator
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = flops / PEAK_FLOPS[dtype] * 1e3
            print(f"[kernel] {name}: max|err| {err:.3e} kernel {ms:.4f} ms (a call through "
                  f"the wrapper {call_ms:.4f} ms) plain "
                  f"{plain_ms:.4f} ms torch.sparse.mm(CSR) "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
                  f"{max(by_bytes, by_ops):.5f} ms "
                  f"({'operations' if by_ops >= by_bytes else 'bytes'}) x{count}+{count}/step "
                  f"bits out {bits(torch, out)} dx {bits(torch, xk.grad)} [{card}]", flush=True)
            agg["err"] = max(agg["err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("by_bytes", by_bytes),
                             ("by_ops", by_ops), ("bound", max(by_bytes, by_ops))):
                agg[key] += 2 * count * val
            if agg["library_ms"] is not None:
                agg["library_ms"] = None if lib_ms is None else agg["library_ms"] + 2 * count * lib_ms
        summary[dtype] = agg
    return summary


def strip_ell(batch):
    """The batch with its ELL arrays dropped: its mat-vecs take the COO route."""
    import dataclasses

    def strip(m):
        return dataclasses.replace(m, ell_cols=None, ell_vals=None)

    return batch.replace(levels=tuple(
        dataclasses.replace(lvl, l0=strip(lvl.l0), l1=strip(lvl.l1)) for lvl in batch.levels))


def flat_task_phase(torch, np, ell, tag, make_model, batch, task, steps, per_step, units,
                    card, skip_grad=()):
    """One flat model on the default (ELL-kernel) route, float32 and
    bfloat16, through ``Trainer``: eval forward (timed), ``steps`` training
    steps (the first apart), launch counts, falling loss, non-zero conv
    gradients.  Returns (launches summed over the training steps, the
    float32 eval output)."""
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    total = {name: 0 for name in ell.LAUNCHES}
    out32 = None
    for dtype in ("float32", "bfloat16"):
        model = make_model(dtype)
        trainer = Trainer(model, TrainerConfig(task=task, lr=1e-3, weight_decay=1e-3,
                                               metric_mode="max"))
        ell.reset_launch_counts()
        out, loss = trainer.eval_step(batch)
        torch.cuda.synchronize()
        if dict(ell.LAUNCHES) != {"spmm_ell": per_step[0], "spmm_ell_bwd": 0}:
            fail(f"{tag} {dtype}: eval forward launched {dict(ell.LAUNCHES)}")
        if not bool(torch.isfinite(out).all()) or out.dtype != torch.float32:
            fail(f"{tag} {dtype}: eval output not finite float32")
        if dtype == "float32":
            out32 = out
        fwd_ms = median_ms(torch, lambda: trainer.eval_step(batch), 10)
        ell.reset_launch_counts()
        losses = [trainer.train_step(batch)]
        torch.cuda.synchronize()
        want = {"spmm_ell": per_step[0], "spmm_ell_bwd": per_step[1]}
        if dict(ell.LAUNCHES) != want:
            fail(f"{tag} {dtype}: training step launched {dict(ell.LAUNCHES)}, expected {want}")
        for name, m in model.named_modules():
            if isinstance(m, conv.LaguerreConv) and name not in skip_grad:
                if m.weight.grad is None or not bool((m.weight.grad != 0).any()):
                    fail(f"{tag} {dtype}: {name}.weight has no gradient")
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        counts = dict(ell.LAUNCHES)
        if counts != {k: v * steps for k, v in want.items()}:
            fail(f"{tag} {dtype}: {counts} launches over {steps} steps")
        for name in total:
            total[name] += counts[name]
        values = [float(x) for x in losses]
        if not all(np.isfinite(values)) or not values[-1] < values[0]:
            fail(f"{tag} {dtype}: loss did not fall or is not finite: {values}")
        val_loss, metric = trainer.evaluate([batch])
        if not (np.isfinite(val_loss) and 0.0 <= metric <= 1.0):
            fail(f"{tag} {dtype}: evaluate gave loss {val_loss}, metric {metric}")
        print(f"[flat] {tag} {dtype}: eval forward {fwd_ms:.3f} ms, step {step_ms:.3f} ms "
              f"({units / step_ms * 1e3:.4e} real edges/s); loss {values[0]:.5f} -> "
              f"{values[-1]:.5f} over {steps} steps; metric {metric:.4f}; launches/step "
              f"{per_step[0]} + {per_step[1]} [{card}]", flush=True)
    return total, out32


def flat_batches(torch, np, samples):
    """The three flat batches on the host and on the card, and their real
    edge counts: zinc_pyr's 384 graphs (the packed path's samples),
    pascalvoc_node's and pcqm_link's."""
    from hl_hgat_tpu_torch.complex.build import attach_link_pairs, collate
    from hl_hgat_tpu_torch.data.synthetic import (
        contact_like_samples, superpixel_like_samples, synthetic_zinc_batch)

    t0 = time.perf_counter()
    zinc_host = synthetic_zinc_batch(BATCH_GRAPHS, seed=0, keig=16, embed_ids=True, with_ell=True)
    if not np.array_equal(zinc_host.x_t, collate(samples).x_t):
        fail("the flat batch does not hold the packed path's samples")
    node_samples = superpixel_like_samples(np.random.default_rng(1), NODE_GRAPHS)
    node_host = collate(node_samples, y_per_node=True, with_ell=True)
    link_samples = contact_like_samples(np.random.default_rng(2), LINK_GRAPHS)
    link_host = attach_link_pairs(collate(link_samples, with_ell=True), link_samples,
                                  np.random.default_rng(3), n_queries=4, n_neg=8)
    hosts = {"zinc": zinc_host, "node": node_host, "link": link_host}
    real = {k: int(b.level0.edge_mask.sum()) for k, b in hosts.items()}
    for k, b in hosts.items():
        l0, l1 = b.level0.l0, b.level0.l1
        print(f"[data] flat {k}: {b.num_graphs} graphs, {int(b.level0.node_mask.sum())} nodes "
              f"(padded {l0.shape[0]}, ELL width {l0.ell_cols.shape[1]}, "
              f"{100 * float((l0.ell_vals != 0).mean()):.1f}% of slots non-zero), "
              f"{real[k]} edges (padded {l1.shape[0]}, width {l1.ell_cols.shape[1]}, "
              f"{100 * float((l1.ell_vals != 0).mean()):.1f}%)", flush=True)
    print(f"[data] flat batches built in {time.perf_counter() - t0:.2f} s host", flush=True)
    return {k: b.to("cuda") for k, b in hosts.items()}, real


def ell_cases(model32, zinc, node):
    """Kernel 5's cases: (tag, operator, trailing feature shape, launches
    per flat zinc_pyr pass) at the widths of zinc_pyr's mat-vecs, then off
    the path a ragged F = 37, a 3-D x and the node batch's operators."""
    from hl_hgat_tpu_torch.nn import conv

    per_width = {}
    for m in model32.modules():
        if isinstance(m, conv.LaguerreConv) and m.weight.shape[0] > 1:
            c = int(m.weight.shape[1])  # K − 1 mat-vecs at the conv's input width
            per_width[c] = per_width.get(c, 0) + int(m.weight.shape[0]) - 1
    if sum(per_width.values()) != 80 or sorted(per_width) != [64, 128, 256]:
        fail(f"zinc_pyr runs {per_width} mat-vecs per forward, expected 80 at 64/128/256")
    cases = []
    for name, coo in (("zinc L0", zinc.level0.l0), ("zinc L1", zinc.level0.l1)):
        # each width's mat-vecs split evenly between the node and the edge conv
        cases += [(name, coo, (c,), n // 2) for c, n in sorted(per_width.items())]
    cases += [("zinc L0 ragged", zinc.level0.l0, (37,), 0),
              ("zinc L1 3-D", zinc.level0.l1, (4, 32), 0)]
    for name, coo in (("node L0", node.level0.l0), ("node L1", node.level0.l1)):
        cases += [(name, coo, (c,), 0) for c in (64, 128, 256)]
    return cases


def print_ell_summary(ell_summary, card):
    for dtype, agg in ell_summary.items():
        lib = "n/a" if agg["library_ms"] is None else f"{agg['library_ms']:.4f} ms"
        print(f"[kernel] spmm_ell {dtype} per flat zinc_pyr step (80 + 80 launches): kernel "
              f"{agg['ms']:.4f} ms, plain {agg['plain_ms']:.4f} ms, torch.sparse.mm(CSR) {lib}, "
              f"bound {agg['bound']:.4f} ms, max|err| {agg['err']:.3e} [{card}]", flush=True)


def flat_phase(torch, np, model32, samples, packed_pred32, card):
    """The flat (COO/ELL) layout at full width; returns the ELL kernel's
    per-step summary and its launches summed over every flat run."""
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.ops import ell_spmm as ell
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, l1_loss

    on_card, real = flat_batches(torch, np, samples)
    zinc, node, link = on_card["zinc"], on_card["node"], on_card["link"]

    # ---- 6. kernel 5 against its plain version ------------------------------
    summary = check_ell(torch, np, ell, ell_cases(model32, zinc, node),
                        np.random.default_rng(4), card)

    # ---- 7a. zinc_pyr on the three flat routes ------------------------------
    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)
    routes = {"gather": (False, zinc), "coo": (True, strip_ell(zinc)), "ell": (True, zinc)}
    per_step = {"gather": (0, 0), "coo": (0, 0), "ell": (80, 80)}
    total = {name: 0 for name in ell.LAUNCHES}
    conv_names = [n for n, m in model32.named_modules() if isinstance(m, conv.LaguerreConv)]
    zero_grad = {n for n, _ in model32.named_parameters()
                 if n.endswith(".bias") and not n.endswith("bn.bias")
                 and "MaskedBatchNorm" not in n and n != "head.out.bias"}

    def grads_of(model):
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    for dtype in ("float32", "bfloat16"):
        seed_model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        evals, calm, first = {}, {}, {}
        for route, (kernel_on, batch) in routes.items():
            ell.use_ell_kernel(kernel_on)
            trainer = Trainer(copy.deepcopy(seed_model), cfg)
            ell.reset_launch_counts()
            out, _ = trainer.eval_step(batch)
            torch.cuda.synchronize()
            if dict(ell.LAUNCHES) != {"spmm_ell": per_step[route][0], "spmm_ell_bwd": 0}:
                fail(f"flat zinc {dtype} {route}: eval forward launched {dict(ell.LAUNCHES)}")
            if out.shape != (BATCH_GRAPHS, 1) or not bool(torch.isfinite(out).all()):
                fail(f"flat zinc {dtype} {route}: output shape {tuple(out.shape)} or not finite")
            evals[route] = out
            fwd_ms = median_ms(torch, lambda: trainer.eval_step(batch), 10)
            # gradients with BN on running statistics (the well-conditioned function)
            trainer.model.eval()
            trainer.model.zero_grad(set_to_none=True)
            loss = l1_loss(trainer.model(batch).reshape(-1), batch.y.reshape(-1))
            loss.backward()
            calm[route] = (float(loss.detach()), grads_of(trainer.model))
            trainer.model.zero_grad(set_to_none=True)
            ell.reset_launch_counts()
            losses = [trainer.train_step(batch)]
            torch.cuda.synchronize()
            want = dict(zip(("spmm_ell", "spmm_ell_bwd"), per_step[route]))
            if dict(ell.LAUNCHES) != want:
                fail(f"flat zinc {dtype} {route}: training step launched {dict(ell.LAUNCHES)}, "
                     f"expected {want}")
            grads = grads_of(trainer.model)
            for name in conv_names:
                if not bool((grads[f"{name}.weight"] != 0).any()):
                    fail(f"flat zinc {dtype} {route}: {name}.weight has no gradient")
            first[route] = (float(losses[0]), grads)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                losses.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            counts = dict(ell.LAUNCHES)
            if counts != {k: v * (TRAIN_STEPS + 1) for k, v in want.items()}:
                fail(f"flat zinc {dtype} {route}: {counts} launches over {TRAIN_STEPS + 1} steps")
            for name in total:
                total[name] += counts[name]
            values = [float(x) for x in losses]
            if not all(np.isfinite(values)) or not values[-1] < values[0]:
                fail(f"flat zinc {dtype} {route}: loss did not fall or is not finite: {values}")
            print(f"[flat] zinc_pyr {dtype} {route}: eval forward {fwd_ms:.3f} ms "
                  f"({BATCH_GRAPHS / fwd_ms * 1e3:.1f} graphs/s), step {step_ms:.3f} ms, "
                  f"{BATCH_GRAPHS / step_ms * 1e3:.1f} graphs/s, "
                  f"{real['zinc'] / step_ms * 1e3:.4e} real edges/s; loss {values[0]:.5f} -> "
                  f"{values[-1]:.5f} over {len(values)} steps; launches/step "
                  f"{per_step[route][0]} + {per_step[route][1]} [{card}]", flush=True)
        ell.use_ell_kernel(True)
        ref = evals["gather"]
        scale = float(ref.abs().max())
        for route in ("ell", "coo"):
            err = float((evals[route] - ref).abs().max())
            print(f"[flat] zinc_pyr {dtype} {route} vs gather route, eval output: max|err| "
                  f"{err:.3e} (max|ref| {scale:.3e})", flush=True)
            if not err <= FLAT_TOL[dtype] * scale:
                fail(f"flat zinc {dtype}: {route} route disagrees with the gather route")
            loss, grads = calm[route]
            if not abs(loss - calm["gather"][0]) <= FLAT_TOL[dtype] * abs(loss):
                fail(f"flat zinc {dtype} {route}: eval-mode loss {loss} vs {calm['gather'][0]}")
            tag = f"flat zinc_pyr {dtype} {route} vs gather route, BN on running statistics"
            if dtype == "float32":
                compare_grads(tag, grads, calm["gather"][1], (), EVAL_LEAF_TOL[dtype],
                              EVAL_NORM_TOL[dtype])
            else:
                compare_grads(tag, grads, calm["gather"][1], (), cosine=FLAT_BF16_COSINE)
            loss, grads = first[route]
            if not abs(loss - first["gather"][0]) <= FLAT_TOL[dtype] * abs(loss):
                fail(f"flat zinc {dtype} {route}: first loss {loss} vs {first['gather'][0]}")
            tag = f"flat zinc_pyr {dtype} {route} vs gather route, first step"
            if dtype == "bfloat16" and route == "coo":
                # printed, not bounded: the COO route rounds every product to
                # bf16 before the f32 sum, and the train-mode gradient
                # amplifies that as it does any rounding (see TRAIN_LEAF_TOL)
                compare_grads(tag, grads, first["gather"][1], zero_grad)
            else:
                compare_train_grads(tag, dtype, grads, first["gather"][1], zero_grad)
        if dtype == "float32":
            # two layouts of one function: the packed path's predictions
            err = float(np.abs(evals["ell"].cpu().numpy() - packed_pred32).max())
            print(f"[flat] zinc_pyr float32 flat vs packed layout, {BATCH_GRAPHS} predictions: "
                  f"max|err| {err:.3e} (max|ref| {float(np.abs(packed_pred32).max()):.3e})",
                  flush=True)
            if not err <= CROSS_LAYOUT_ATOL:
                fail("the flat and the packed layout disagree")

    # ---- 7b. pascalvoc_node --------------------------------------------------
    counts, out = flat_task_phase(
        torch, np, ell, "pascalvoc_node",
        lambda dtype: presets.pascalvoc_node(compute_dtype=dtype, seed=0)[0],
        node, "node_classification", TRAIN_STEPS + 1, (36, 36), real["node"], card)
    pad = node.level0.node_mask == 0
    if out.shape != (node.level0.num_nodes, 21) or not bool(pad.any()) or bool(out[pad].any()):
        fail("pascalvoc_node: logits must be [N, 21] and exactly 0 on padded nodes")
    for name in total:
        total[name] += counts[name]

    # ---- 7c. pcqm_link -------------------------------------------------------
    counts, out = flat_task_phase(
        torch, np, ell, "pcqm_link",
        lambda dtype: presets.pcqm_link(compute_dtype=dtype, seed=0)[0],
        link, "link_prediction", LINK_STEPS, (36, 33), real["link"], card,
        skip_grad=("backbone.NEConv21.edge.conv",))
    if out.shape != (LINK_GRAPHS * 4 * 9,):
        fail(f"pcqm_link: {tuple(out.shape)} pair logits, expected {LINK_GRAPHS * 4 * 9}")
    for name in total:
        total[name] += counts[name]
    return summary, total


def check_band_kernels(torch, np, lg, cases, seed):
    """The four Laguerre kernels against their plain versions on blocks
    over 128 rows (the band kernels), both dtypes; ``cases`` holds
    ``(tag, l_blocks [G,S,S] float32, K, C, F, launches per pass)``.  Each
    case draws its inputs from its own generator.  Returns per-kernel,
    per-dtype sums over one pass's launches, as ``check_kernels`` does."""
    summary = empty_summary(lg)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for tag, l32, k, c, f, count in cases:
            g, sb = l32.shape[:2]
            lb = l32.to(td)
            rng = np.random.default_rng([seed, sb, k, c, f])

            def feats(width):
                return torch.from_numpy(
                    rng.standard_normal((g, sb, width)).astype(np.float32)).cuda().to(td)

            x = feats(c)
            w = torch.from_numpy((rng.uniform(-1, 1, (k, c, f)) * np.sqrt(6.0 / (c + f))
                                  ).astype(np.float32)).cuda()
            b = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).cuda()
            cot = feats(f)
            check_fused_pair(torch, lg, dtype, f"{tag} ", lb, x, w, b, cot, count, summary)
            if k > 1:
                dt = torch.stack([feats(c) for _ in range(k)])
                check_terms_pair(torch, lg, dtype, f"{tag} ", lb, x, dt, count, summary)
    return summary


def conv_calls(torch, conv, model, batch):
    """``(operator, K, C, F)`` of every dense Laguerre conv of one eval
    forward, in call order (read by hooks on the plain route, which
    launches no kernel)."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append((args[1], *mod.weight.shape)))
        for m in model.modules() if isinstance(m, conv.LaguerreConv)]
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    conv.use_fused_dense(False)
    conv.use_terms_kernel(False)
    try:
        model.eval()
        with torch.inference_mode():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])
    return calls


def band_cases(torch, np, conv, model, batch, wide_l1):
    """Kernel cases over 128 rows: every distinct (operator, K, C, F) of the
    pooled model's forward with S > 128, counted per pass, then off the
    path the 512-row L1 blocks ``wide_l1`` at K = 4, C = F = 64 and 128."""
    counted = {}
    for lap, k, c, f in conv_calls(torch, conv, model, batch):
        if lap.shape[1] > 128:
            key = (lap.data_ptr(), int(k), int(c), int(f))
            lap0, n = counted.get(key, (lap, 0))
            counted[key] = (lap0, n + 1)
    if not counted:
        fail("the pooled batch has no block over 128 rows")
    cases = [("pooled", lap.float(), k, c, f, n)
             for (_, k, c, f), (lap, n) in sorted(counted.items(), key=lambda kv: kv[0][1:])]
    cases += [("wide", wide_l1, 4, w, w, 0) for w in (64, 128)]
    return cases


def band_phase(torch, np, lg, conv, model32, pooled_batch, wide_l1, card):
    """Phase 2b: the band kernels at the pooled path's shapes and at 512
    rows; returns the summary over one pooled forward's (backward's)
    launches over 128 rows."""
    cases = band_cases(torch, np, conv, model32, pooled_batch, wide_l1)
    summary = check_band_kernels(torch, np, lg, cases, 2)
    for name in lg.LAUNCHES:
        for dtype in ("float32", "bfloat16"):
            agg = summary[(name, dtype)]
            print(f"[kernel] {name} {dtype} blocks over 128 rows, per pooled pass: kernel "
                  f"{agg['ms']:.4f} ms, plain {agg['plain_ms']:.4f} ms, bound "
                  f"{agg['bound']:.4f} ms, max|err| {agg['err']:.3e} [{card}]", flush=True)
    return summary


def zinc_wide_phase(torch, np, lg, model32, samples, served, card):
    """Phase 3b: zinc_pyr served through ``Predictor(edge_cap=256)`` (256-row
    L1 blocks, the band kernels) in both dtypes, held against the 128-row
    packing's predictions ``served[dtype]``; then ZINC_WIDE_STEPS training
    steps at ``edge_cap=256`` in float32, the first loss against the
    128-row packing's.  Returns the launches."""
    from hl_hgat_tpu_torch.complex.compact import maybe_inflate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import Predictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    total = {name: 0 for name in lg.LAUNCHES}
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=BATCH_GRAPHS, edge_cap=256)
        batch = maybe_inflate(pred.collate(samples))  # the loader's derived batch, inflated
        if batch.levels[0].l1.shape[1] != 256:
            fail(f"Predictor(edge_cap=256) packed L1 blocks of {batch.levels[0].l1.shape[1]}")
        lg.reset_launch_counts()
        out = pred(samples)
        counts = dict(lg.LAUNCHES)
        if counts["laguerre_dense_fused"] != 18 or sum(counts.values()) != 18:
            fail(f"zinc_pyr edge_cap=256 {dtype} forward launched {counts}")
        for name in total:
            total[name] += counts[name]
        ref = served[dtype]
        err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        if out.shape != ref.shape or not np.isfinite(out).all() or not err <= TOL[dtype] * scale:
            fail(f"zinc_pyr edge_cap=256 {dtype}: max|err| {err:.3e} against the 128-row "
                 f"packing (max|ref| {scale:.3e})")
        fwd_ms = median_ms(torch, lambda: pred.forward(batch), 10)
        print(f"[serve] zinc_pyr {dtype} edge_cap=256 ({batch.x_t.shape[0]} blocks, L1 "
              f"{batch.levels[0].l1.shape[1]} rows): forward {fwd_ms:.3f} ms, 18 fused launches; "
              f"vs edge_cap=128 max|err| {err:.3e} (max|ref| {scale:.3e}) [{card}]", flush=True)
    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)
    firsts = {}
    for cap in (128, 256):
        trainer = Trainer(copy.deepcopy(model32), cfg)
        batch = collate_dense_packed(samples, edge_cap=cap).to("cuda")
        lg.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch) for _ in range(ZINC_WIDE_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / ZINC_WIDE_STEPS
        counts = dict(lg.LAUNCHES)
        want = {**{n: 0 for n in lg.LAUNCHES}, "laguerre_dense_fused": 18 * ZINC_WIDE_STEPS,
                "laguerre_dense_fused_bwd": 18 * ZINC_WIDE_STEPS}
        if counts != want:
            fail(f"zinc_pyr edge_cap={cap} training launched {counts}, expected {want}")
        values = [float(v) for v in losses]
        if not all(np.isfinite(values)):
            fail(f"zinc_pyr edge_cap={cap}: non-finite loss {values}")
        firsts[cap] = values[0]
        if cap == 256:
            for name in total:
                total[name] += counts[name]
        print(f"[train] zinc_pyr float32 edge_cap={cap}: {ZINC_WIDE_STEPS} steps, "
              f"{step_ms:.3f} ms a step (first included), 18 + 18 launches a step, loss "
              f"{values[0]:.5f} -> {values[-1]:.5f} [{card}]", flush=True)
    if not abs(firsts[256] - firsts[128]) <= TOL["float32"] * abs(firsts[128]):
        fail(f"zinc_pyr first loss {firsts[256]} at edge_cap=256 vs {firsts[128]} at 128")
    return total


def device_profile(torch, fn, calls: int, top: int = 0):
    """(device kernel ms per call, busy share, the ``top`` device operations
    as (name, ms per call, launches per call)) over ``calls`` calls of
    ``fn`` traced by ``torch.profiler``: busy share is the kernels' summed
    device time over the window's wall time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [(e.key, getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0), e.count)
           for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(us for _, us, _ in ops)
    ops.sort(key=lambda o: -o[1])
    return (dev_us / 1e3 / calls, dev_us / 1e6 / wall,
            [(name, us / 1e3 / calls, n / calls) for name, us, n in ops[:top]])


def pooled_phase(torch, np, lg, ell, model32, samples, card):
    """Phase 8: cifar10sp_attpool at full width on POOLED_GRAPHS packed graphs
    (node_cap 128, edge_cap 256): served through ``Predictor`` and trained
    POOLED_STEPS steps through ``Trainer`` in both dtypes on the default
    fused route, with the launch counts of each run; gradients with BN on
    running statistics held against the plain route; one eval forward of
    the flat layout on the ELL kernel, held against the packed
    predictions.  Returns (Laguerre launches, ELL launches)."""
    from hl_hgat_tpu_torch.complex.build import collate
    from hl_hgat_tpu_torch.complex.compact import maybe_inflate
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.serving import Predictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, softmax_ce_loss

    per_fwd = sum(1 for m in model32.modules() if isinstance(m, conv.LaguerreConv))
    if per_fwd != 14:
        fail(f"cifar10sp_attpool has {per_fwd} Laguerre convs, expected 14")
    total = {name: 0 for name in lg.LAUNCHES}
    cfg = TrainerConfig(task="classification", lr=1e-3, weight_decay=1e-3, metric_mode="max")
    preds32 = None
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.cifar10sp_attpool(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=POOLED_GRAPHS, edge_cap=256)
        batch = maybe_inflate(pred.collate(samples))  # the loader's derived batch, inflated
        lg.reset_launch_counts()
        out = pred(samples)
        counts = dict(lg.LAUNCHES)
        if counts["laguerre_dense_fused"] != per_fwd or sum(counts.values()) != per_fwd:
            fail(f"cifar10sp_attpool {dtype} forward launched {counts}")
        for name in total:
            total[name] += counts[name]
        if out.shape != (POOLED_GRAPHS, 10) or not np.isfinite(out).all():
            fail(f"cifar10sp_attpool {dtype}: output {out.shape} or not finite")
        conv.use_fused_dense(False)
        ref = pred(samples)
        conv.use_fused_dense(True)
        err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        if not err <= TOL[dtype] * scale:
            fail(f"cifar10sp_attpool {dtype}: fused route vs plain route max|err| {err:.3e} "
                 f"> {TOL[dtype]}·{scale:.3e}")
        fwd_ms = median_ms(torch, lambda: pred.forward(batch), 10)
        fwd_dev, fwd_busy, _ = device_profile(torch, lambda: pred.forward(batch), 3)
        print(f"[pooled] cifar10sp_attpool {dtype}: {batch.x_t.shape[0]} blocks, L1 "
              f"{[lvl.l1.shape[1] for lvl in batch.levels]} rows by level; forward "
              f"{fwd_ms:.3f} ms (device {fwd_dev:.3f} ms, busy {100 * fwd_busy:.1f}%), "
              f"{POOLED_GRAPHS / fwd_ms * 1e3:.1f} graphs/s; fused vs plain route max|err| "
              f"{err:.3e} (max|ref| {scale:.3e}); launches/forward {per_fwd} [{card}]",
              flush=True)
        if dtype == "float32":
            preds32 = out
            cpu_out = Predictor(copy.deepcopy(model).to("cpu"), batch_size=16, edge_cap=256,
                                device="cpu")(samples[:16])
            cerr = float(np.abs(out[:16] - cpu_out).max())
            print(f"[pooled] float32 card vs CPU forward (16 graphs): max|err| {cerr:.3e} "
                  f"(max|ref| {float(np.abs(cpu_out).max()):.3e})", flush=True)
            if not cerr <= TOL[dtype] * float(np.abs(cpu_out).max()):
                fail("cifar10sp_attpool: card output disagrees with the CPU forward")

        # gradients with BN on running statistics (no dropout): fused vs plain route
        grads = {}
        for fused in (True, False):
            conv.use_fused_dense(fused)
            m = copy.deepcopy(model).eval()
            loss = softmax_ce_loss(m(batch), batch.y.reshape(-1).long())
            loss.backward()
            grads[fused] = (float(loss.detach()), {
                n: (torch.zeros_like(q) if q.grad is None else q.grad.detach().clone())
                for n, q in m.named_parameters()})
        conv.use_fused_dense(True)
        if not abs(grads[True][0] - grads[False][0]) <= TOL[dtype] * abs(grads[False][0]):
            fail(f"cifar10sp_attpool {dtype}: eval loss {grads[True][0]} vs {grads[False][0]}")
        tag = f"pooled cifar10sp_attpool {dtype} fused vs plain route, BN on running statistics"
        if dtype == "float32":
            compare_grads(tag, grads[True][1], grads[False][1], (), EVAL_LEAF_TOL[dtype],
                          EVAL_NORM_TOL[dtype])
        else:
            compare_grads(tag, grads[True][1], grads[False][1], (), cosine=TRAIN_BF16_COSINE)

        trainer = Trainer(copy.deepcopy(model), cfg)
        lg.reset_launch_counts()
        losses = [trainer.train_step(batch)]
        torch.cuda.synchronize()
        for name, m in trainer.model.named_modules():
            if isinstance(m, conv.LaguerreConv) and not bool((m.weight.grad != 0).any()):
                fail(f"cifar10sp_attpool {dtype}: {name}.weight has no gradient")
        t0 = time.perf_counter()
        for _ in range(POOLED_STEPS - 1):
            losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (POOLED_STEPS - 1)
        counts = dict(lg.LAUNCHES)
        want = {**{n: 0 for n in lg.LAUNCHES}, "laguerre_dense_fused": per_fwd * POOLED_STEPS,
                "laguerre_dense_fused_bwd": per_fwd * POOLED_STEPS}
        if counts != want:
            fail(f"cifar10sp_attpool {dtype}: {counts} over {POOLED_STEPS} steps, expected {want}")
        for name in total:
            total[name] += counts[name]
        values = [float(v) for v in losses]
        if not all(np.isfinite(values)):
            fail(f"cifar10sp_attpool {dtype}: non-finite loss {values}")
        step_dev, step_busy, _ = device_profile(torch, lambda: trainer.train_step(batch), 2)
        print(f"[pooled] cifar10sp_attpool {dtype}: step {step_ms:.3f} ms (device {step_dev:.3f} "
              f"ms, busy {100 * step_busy:.1f}%), {POOLED_GRAPHS / step_ms * 1e3:.1f} graphs/s; "
              f"loss {values[0]:.5f} -> {values[-1]:.5f} over {POOLED_STEPS} steps; launches/step "
              f"{per_fwd} + {per_fwd} [{card}]", flush=True)

    # the flat layout's eval forward on the ELL kernel
    flat = collate(samples, with_ell=True).to("cuda")
    model32.eval()
    ell.reset_launch_counts()
    with torch.inference_mode():
        out = model32(flat)
    torch.cuda.synchronize()
    ell_counts = dict(ell.LAUNCHES)
    per_flat = sum(int(m.weight.shape[0]) - 1 for m in model32.modules()
                   if isinstance(m, conv.LaguerreConv))
    if ell_counts != {"spmm_ell": per_flat, "spmm_ell_bwd": 0}:
        fail(f"cifar10sp_attpool flat forward launched {ell_counts}, expected {per_flat}")
    err = float(np.abs(out.float().cpu().numpy() - preds32).max())
    scale = float(np.abs(preds32).max())
    print(f"[pooled] cifar10sp_attpool float32 flat (ELL) vs packed predictions: max|err| "
          f"{err:.3e} (max|ref| {scale:.3e}); ELL launches {per_flat} [{card}]", flush=True)
    if not err <= TOL["float32"] * scale:
        fail("cifar10sp_attpool: the flat and the packed layout disagree")
    return total, ell_counts


def tsp_phase(torch, np, lg, ell, card):
    """Phase 9: the large-graph layout and the TSP edge-level model at the
    full width of the TSP-500 configuration, in both dtypes.  Trains
    TSP_GRAPHS graphs packed into spanning blocks (banded: blocks, bands
    and spills; the plain recurrence, no hand kernel, as in the JAX
    package), with and without the augmentation, and evaluates them; holds
    the banded forward and one step's gradients against the flat layout
    (ELL kernel); checks the augmentation's mask; serves TSP_SERVE_GRAPHS
    small graphs edge by edge through ``Predictor(edge_level=True)`` (fused
    kernel on 128-row L0 and 512-row L1 blocks) against the plain route and
    the CPU.  Returns (Laguerre launches, ELL launches) of the phase."""
    from hl_hgat_tpu_torch.complex.augment import apply_tsp_keep, tsp_keep
    from hl_hgat_tpu_torch.complex.build import collate
    from hl_hgat_tpu_torch.complex.compact import maybe_inflate
    from hl_hgat_tpu_torch.complex.dense import BlockDiagMatrix, collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import tsp_like_samples
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.serving import Predictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, focal_loss

    t0 = time.perf_counter()
    samples = tsp_like_samples(TSP_GRAPHS, seed=0)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = collate_dense_packed(samples, y_per_edge=True, **TSP_CAPS)
    collate_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    flat_host = collate(samples, y_per_edge=True, with_ell=True)
    flat_ms = (time.perf_counter() - t0) * 1e3
    lvl = host.level0
    if not (isinstance(lvl.l0, BlockDiagMatrix) and isinstance(lvl.l1, BlockDiagMatrix)):
        fail("the TSP-500 batch packed without spanning blocks")

    def nnz(coo):
        return 0 if coo is None else int((coo.vals != 0).sum())

    bands = [name for name, b in (("L0 up", lvl.l0.band_up), ("L0 down", lvl.l0.band_dn),
                                  ("L1 up", lvl.l1.band_up), ("L1 down", lvl.l1.band_dn),
                                  ("B1 up", lvl.b1_bu), ("B1 down", lvl.b1_bd)) if b is not None]
    real_nodes, real_edges = int(lvl.node_mask.sum()), int(lvl.edge_mask.sum())
    print(f"[tsp] {TSP_GRAPHS} graphs ({min(s.num_nodes for s in samples)}-"
          f"{max(s.num_nodes for s in samples)} nodes, up to "
          f"{max(s.num_edges for s in samples)} edges), {real_nodes} real nodes, {real_edges} "
          f"real edges; {host.x_t.shape[0]} blocks of ({host.x_t.shape[1]}, "
          f"{host.x_s.shape[1]}) rows; spill nnz L0 {nnz(lvl.l0.spill)}, L1 {nnz(lvl.l1.spill)}, "
          f"B1 {nnz(lvl.b1_sp)}; bands: {', '.join(bands)}; host: build {build_s:.2f} s, "
          f"packed collate {collate_ms:.1f} ms, flat collate (ELL) {flat_ms:.1f} ms", flush=True)

    cfg = TrainerConfig(task="edge_binary", lr=1e-3, weight_decay=1e-3, metric_mode="max")
    total = {name: 0 for name in lg.LAUNCHES}
    ell_total = {name: 0 for name in ell.LAUNCHES}
    none = {name: 0 for name in lg.LAUNCHES}
    batch, flat = host.to("cuda"), flat_host.to("cuda")
    gid = lvl.s_gid.reshape(-1)
    real = lvl.edge_mask.reshape(-1) > 0
    order = np.concatenate([np.nonzero((gid == g) & real)[0] for g in range(TSP_GRAPHS)])
    flat_real = flat_host.level0.edge_mask > 0  # graphs in order, then padding
    serve = tsp_like_samples(TSP_SERVE_GRAPHS, seed=1, min_nodes=50, max_nodes=80)

    def grads_of(model):
        return {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                for n, p in model.named_parameters()}

    for dtype in ("float32", "bfloat16"):
        model, _ = presets.tsp_pyr(**TSP_MODEL, compute_dtype=dtype, seed=0)
        convs = [n for n, m in model.named_modules() if isinstance(m, conv.LaguerreConv)]
        per_flat = sum(int(m.weight.shape[0]) - 1 for m in model.modules()
                       if isinstance(m, conv.LaguerreConv))
        zero_grad = {n for n, _ in model.named_parameters()
                     if n.endswith(".bias") and not n.endswith("bn.bias") and n != "out.bias"}

        # banded training: a warm-up step, TSP_STEPS timed, TSP_STEPS augmented
        trainer = Trainer(copy.deepcopy(model), cfg)
        lg.reset_launch_counts()
        ell.reset_launch_counts()
        losses = [trainer.train_step(batch)]
        torch.cuda.synchronize()
        for name, m in trainer.model.named_modules():
            if isinstance(m, conv.LaguerreConv) and not bool((m.weight.grad != 0).any()):
                fail(f"tsp {dtype}: {name}.weight has no gradient")
        t0 = time.perf_counter()
        for _ in range(TSP_STEPS):
            losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TSP_STEPS
        aug = Trainer(copy.deepcopy(model), dataclasses.replace(cfg, tsp_aug_prob=0.75))
        aug_losses = [aug.train_step(batch) for _ in range(TSP_STEPS)]
        val_loss, f1 = trainer.evaluate([batch])
        if dict(lg.LAUNCHES) != none or sum(ell.LAUNCHES.values()):
            fail(f"tsp {dtype}: the banded layout launched {dict(lg.LAUNCHES)} "
                 f"{dict(ell.LAUNCHES)}; it takes the plain recurrence")
        values = [float(v) for v in losses + aug_losses] + [val_loss]
        if not all(np.isfinite(values)) or not 0.0 <= f1 <= 1.0:
            fail(f"tsp {dtype}: losses {values}, F1 {f1}")
        fwd_ms = median_ms(torch, lambda: trainer.eval_step(batch), 10)
        step_dev, step_busy, step_top = device_profile(
            torch, lambda: trainer.train_step(batch), 2, top=6)
        fwd_dev, fwd_busy, fwd_top = device_profile(
            torch, lambda: trainer.eval_step(batch), 3, top=6)
        print(f"[tsp] {dtype} banded: step {step_ms:.3f} ms (mean of {TSP_STEPS} after one "
              f"warm-up; device {step_dev:.3f} ms, busy {100 * step_busy:.1f}%), "
              f"{real_edges / step_ms * 1e3:.4e} real edges/s; eval forward {fwd_ms:.3f} ms "
              f"(median of 10; device {fwd_dev:.3f} ms, busy {100 * fwd_busy:.1f}%); loss "
              f"{values[0]:.3f} -> {values[TSP_STEPS]:.3f}, augmented {values[TSP_STEPS + 1]:.3f}"
              f" -> {values[2 * TSP_STEPS]:.3f}, eval loss {val_loss:.3f}, F1 {f1:.4f}; "
              f"hand launches 0 [{card}]", flush=True)
        for what, top in (("step", step_top), ("forward", fwd_top)):
            print(f"[tsp] {dtype} banded {what}, top device operations: " + "; ".join(
                f"{name[:60]} {ms:.3f} ms x{n:g}" for name, ms, n in top), flush=True)

        # banded against flat (ELL kernel): eval forward per edge, one step's gradients
        model.eval()
        with torch.inference_mode():
            out_b = model(batch).float().reshape(-1).cpu().numpy()[order]
            ell.reset_launch_counts()
            out_f = model(flat).float().reshape(-1).cpu().numpy()[flat_real]
        if dict(ell.LAUNCHES) != {"spmm_ell": per_flat, "spmm_ell_bwd": 0}:
            fail(f"tsp {dtype}: the flat forward launched {dict(ell.LAUNCHES)}, want {per_flat}")
        for name in ell_total:
            ell_total[name] += ell.LAUNCHES[name]
        err, scale = float(np.abs(out_b - out_f).max()), float(np.abs(out_f).max())
        print(f"[tsp] {dtype} banded vs flat (ELL) eval forward, {real_edges} edges: max|err| "
              f"{err:.3e} (max|ref| {scale:.3e}); ELL launches {per_flat}", flush=True)
        if out_b.shape != out_f.shape or (
                not np.allclose(out_b, out_f, rtol=1e-3, atol=1e-4) if dtype == "float32"
                else not err <= FLAT_TOL[dtype] * scale):
            fail(f"tsp {dtype}: the banded and the flat layout disagree")
        grads = {}
        for name, data in (("banded", batch), ("flat", flat)):
            m = copy.deepcopy(model).train()
            out = m(data)
            loss = focal_loss(out.reshape(-1), data.y.reshape(-1),
                              data.level0.edge_mask.reshape(-1))
            loss.backward()
            grads[name] = (float(loss.detach()), grads_of(m))
        for name in convs:
            if not bool((grads["banded"][1][f"{name}.weight"] != 0).any()):
                fail(f"tsp {dtype}: {name}.weight has no gradient on the banded layout")
        loss_b, loss_f = grads["banded"][0], grads["flat"][0]
        print(f"[tsp] {dtype} train-mode loss banded {loss_b:.5f}, flat {loss_f:.5f}", flush=True)
        if not abs(loss_b - loss_f) <= FLAT_TOL[dtype] * abs(loss_f):
            fail(f"tsp {dtype}: train-mode loss differs between the layouts")
        compare_train_grads(f"tsp {dtype} banded vs flat layout, one step", dtype,
                            grads["banded"][1], grads["flat"][1], zero_grad)

        # the augmentation: one generator seed, one mask; tour edges kept; logits 0 where dropped
        keeps = [tsp_keep(batch, apply_prob=0.75,
                          generator=torch.Generator(device="cuda").manual_seed(7))
                 for _ in range(2)]
        keep = keeps[0]
        y = batch.y.reshape(-1)
        if not torch.equal(keeps[0], keeps[1]) or not bool((keep[y > 0] == 1).all()):
            fail(f"tsp {dtype}: the augmentation mask is not reproducible or drops a tour edge")
        with torch.inference_mode():
            out = model(apply_tsp_keep(batch, keep)).reshape(-1)
        dropped = int(((keep == 0) & batch.level0.edge_mask.reshape(-1).bool()).sum())
        if not dropped or not bool((out[keep == 0] == 0).all()):
            fail(f"tsp {dtype}: {dropped} dropped edges, logits not 0 where dropped")
        print(f"[tsp] {dtype} augmentation: {dropped} of {real_edges} edges dropped, the same "
              f"mask twice, tour edges kept, their logits 0", flush=True)

        # edge-level serving on blocks that fit: fused kernel vs plain route vs CPU
        pred = Predictor(model, batch_size=TSP_SERVE_GRAPHS, edge_level=True, **TSP_CAPS)
        sbatch = maybe_inflate(pred.collate(serve))  # the loader's derived batch, inflated
        lg.reset_launch_counts()
        outs = pred(serve)
        counts = dict(lg.LAUNCHES)
        n_convs = len(convs)
        n_l0 = sum(1 for n in convs if n.startswith("backbone.init_node") or ".node." in n)
        if counts != {**none, "laguerre_dense_fused": n_convs}:
            fail(f"tsp {dtype} serving launched {counts}, expected {n_convs} fused")
        for name in total:
            total[name] += counts[name]
        if len(outs) != TSP_SERVE_GRAPHS or any(
                o.shape != (s.num_edges, 1) or not np.isfinite(o).all()
                for o, s in zip(outs, serve)):
            fail(f"tsp {dtype} serving: {len(outs)} arrays or wrong shapes")
        conv.use_fused_dense(False)
        plain = pred(serve)
        conv.use_fused_dense(True)
        got, ref = np.concatenate(outs), np.concatenate(plain)
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        if not err <= TOL[dtype] * scale:
            fail(f"tsp {dtype} serving: fused vs plain route max|err| {err:.3e} > "
                 f"{TOL[dtype]}·{scale:.3e}")
        s_fwd = median_ms(torch, lambda: pred.forward(sbatch), 10)
        t0 = time.perf_counter()
        pred(serve)
        call_ms = (time.perf_counter() - t0) * 1e3
        s_dev, s_busy, s_top = device_profile(torch, lambda: pred.forward(sbatch), 3, top=6)
        print(f"[tsp] {dtype} edge-level serving, {TSP_SERVE_GRAPHS} graphs "
              f"({sum(s.num_edges for s in serve)} edges) in {sbatch.x_t.shape[0]} blocks of "
              f"({sbatch.x_t.shape[1]}, {sbatch.x_s.shape[1]}) rows: forward {s_fwd:.3f} ms "
              f"(device {s_dev:.3f} ms, busy {100 * s_busy:.1f}%), Predictor call {call_ms:.1f} "
              f"ms; {n_convs} fused launches a forward ({n_l0} on L0 at 128 rows, "
              f"{n_convs - n_l0} on L1 at 512); fused vs plain route max|err| {err:.3e} (max|ref| "
              f"{scale:.3e}) [{card}]", flush=True)
        print(f"[tsp] {dtype} serving forward, top device operations: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms x{n:g}" for name, ms, n in s_top), flush=True)
        if dtype == "float32":
            cpu = Predictor(copy.deepcopy(model).to("cpu"), batch_size=8, edge_level=True,
                            device="cpu", **TSP_CAPS)(serve[:8])
            cerr = max(float(np.abs(a - b).max()) for a, b in zip(outs[:8], cpu))
            cscale = max(float(np.abs(b).max()) for b in cpu)
            print(f"[tsp] float32 serving, card vs CPU (8 graphs): max|err| {cerr:.3e} "
                  f"(max|ref| {cscale:.3e})", flush=True)
            if not cerr <= TOL[dtype] * cscale:
                fail("tsp: the card's edge-level predictions disagree with the CPU's")
    return total, ell_total


def brain_conv_cases(torch, conv, model, batch):
    """``(level, operator name, S, K, folded C, launches per forward)`` of
    every Laguerre conv with K > 1 of one eval forward on the shared
    layout, read by hooks on the plain route (which launches no kernel);
    the folded C is the graph count times the conv's input width."""
    ids = {}
    for i, lvl in enumerate(batch.levels):
        ids[lvl.l0.data_ptr()] = (i, "L0")
        ids[lvl.l1.data_ptr()] = (i, "L1")
    counted = {}

    def hook(mod, args, out):
        x, lap = args[:2]
        key = (*ids[lap.data_ptr()], lap.shape[1], int(mod.weight.shape[0]),
               x.shape[0] * x.shape[2])
        counted[key] = counted.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, conv.LaguerreConv)]
    prev = conv.use_fused_dense(), conv.use_terms_kernel()
    conv.use_fused_dense(False)
    conv.use_terms_kernel(False)
    try:
        model.eval()
        with torch.inference_mode():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
        conv.use_fused_dense(prev[0])
        conv.use_terms_kernel(prev[1])
    return [(*key, n) for key, n in sorted(counted.items()) if key[3] > 1]


def brain_data(np, with_flat: bool = True):
    """The Shen-268 pyramid rebuilt from the reference fixture's skeleton
    (checked against the fixture's assignments and coarse edges), the
    BRAIN_SUBJECTS synthetic series and the first BRAIN_BATCH subjects
    collated on the host: (levels, pools, series, shared batch, flat batch
    with ELL arrays or None)."""
    import pathlib

    from hl_hgat_tpu_torch.complex.build import collate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
    from hl_hgat_tpu_torch.data.brain import brain_pyramid
    from hl_hgat_tpu_torch.data.datasets import brain_sample
    from hl_hgat_tpu_torch.data.synthetic import synthetic_fmri_series

    with np.load(pathlib.Path(__file__).resolve().parent / BRAIN_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    levels, pools = brain_pyramid(fx["skeleton_src"], fx["skeleton_dst"], fx["skeleton_val"],
                                  pool_num=2, seed=10086)
    build_ms = (time.perf_counter() - t0) * 1e3
    for k, (pt, ps) in enumerate([("pos_t0", "pos_s0"), ("pos_t1", "pos_s1")]):
        for ours, key in zip(pools[k], (pt, ps)):
            if not np.array_equal(np.where(ours < 0, np.inf, ours.astype(np.float64)),
                                  fx[key].reshape(-1).astype(np.float64)):
                fail(f"brain pyramid: pool {k} differs from the fixture's {key}")
    for lvl, key in ((levels[1], "l1_edge_index"), (levels[2], "l2_edge_index")):
        if not np.array_equal(np.stack([lvl.src, lvl.dst]), fx[key]):
            fail(f"brain pyramid: {key} differs from the fixture's")
    sizes = [(lvl.num_nodes, lvl.num_edges) for lvl in levels]
    if sizes != list(zip(fx["num_node"].tolist(), fx["num_edge"].tolist())):
        fail(f"brain pyramid sizes {sizes}")

    series, scores = synthetic_fmri_series(np.random.default_rng(0), BRAIN_SUBJECTS,
                                           sizes[0][0], BRAIN_T)
    src, dst = levels[0].src, levels[0].dst
    t0 = time.perf_counter()
    samples = [brain_sample(series[i], src, dst, levels, pools, y=float(scores[i]))
               for i in range(BRAIN_BATCH)]
    host = collate_dense_shared(samples)
    collate_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    flat_host = collate(samples, multiple=1, with_ell=True) if with_flat else None
    flat_ms = (time.perf_counter() - t0) * 1e3
    print(f"[brain] Shen-268 pyramid (nodes, edges) by level {sizes}, equal to the fixture's; "
          f"{BRAIN_BATCH} subjects of T = {BRAIN_T}; shared operators L1 "
          f"{[tuple(lvl.l1.shape) for lvl in host.levels]}; host: pyramid {build_ms:.1f} ms, "
          f"samples + shared collate {collate_ms:.1f} ms, flat collate (ELL) {flat_ms:.1f} ms",
          flush=True)
    return levels, pools, series, host, flat_host


def brain_phase(torch, np, lg, ell, card):
    """Phase 10: the brain family on the shared-skeleton layout at full
    width.  Rebuilds the Shen-268 pyramid from the reference fixture's
    skeleton (checked against the fixture's assignments and coarse edges);
    holds kernels 2 and 4 on the folded level-0 and level-1 L1 shapes
    against their plain versions in both dtypes; serves BRAIN_SUBJECTS
    subjects through ``BrainPredictor`` with ``hgat_attpool`` and trains it
    BRAIN_STEPS steps per dtype (terms launches only, none fused); holds the
    shared forward against the plain route and the float32 one against the
    flat layout (ELL kernel); serves ``abcd_attpool`` once per dtype.
    Returns (Laguerre launches, ELL launches, kernel summary) of the phase."""
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.serving import BrainPredictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    levels, pools, series, host, flat_host = brain_data(np)
    batch, flat = host.to("cuda"), flat_host.to("cuda")
    final, fine = levels[2], levels[0]
    widths = dict(nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
                  fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges)

    # kernels 2 and 4 on the folded L1 shapes of levels 0 and 1
    model32, _ = presets.hgat_attpool(**BRAIN_MODEL, **widths, seed=0)
    cases = brain_conv_cases(torch, conv, model32, batch)
    per_fwd = sum(n for *_, n in cases)
    summary = empty_summary(lg)
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for lv, op, s, k, c, count in cases:
            if op != "L1" or lv > 1:
                continue
            lb = getattr(batch.levels[lv], "l1").to(td)
            rng = np.random.default_rng([3, s, k, c])
            x = torch.from_numpy(rng.standard_normal((1, s, c)).astype(np.float32)).cuda().to(td)
            dt = torch.from_numpy(rng.standard_normal((k, 1, s, c)).astype(np.float32)
                                  ).cuda().to(td)
            check_terms_pair(torch, lg, dtype, f"brain level {lv} L1 folded ", lb, x, dt,
                             count, summary)
    print(f"[brain] kernel checks: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()

    none = {name: 0 for name in lg.LAUNCHES}
    total = dict(none)
    fields = ("pred", "latent", "node_att", "edge_att")
    shapes = {"pred": (1,), "latent": (BRAIN_MODEL["mlp_channels"][-1],),
              "node_att": (fine.num_nodes,), "edge_att": (fine.num_edges,)}
    cfg = TrainerConfig(task="brain", lr=1e-4, weight_decay=1e-4, metric_mode="max")
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.hgat_attpool(
            **BRAIN_MODEL, **widths, compute_dtype=dtype, seed=0)[0]
        pred = BrainPredictor(model, levels, pools, batch_size=BRAIN_BATCH)
        lg.reset_launch_counts()
        out = pred(list(series))
        counts = dict(lg.LAUNCHES)
        n_batches = -(-BRAIN_SUBJECTS // BRAIN_BATCH)
        if counts != {**none, "laguerre_terms_dense": per_fwd * n_batches}:
            fail(f"hgat_attpool {dtype} serving launched {counts}, expected {per_fwd} terms "
                 f"launches a forward and nothing else")
        for name in total:
            total[name] += counts[name]
        for f in fields:
            if out[f].shape != (BRAIN_SUBJECTS, *shapes[f]) or not np.isfinite(out[f]).all():
                fail(f"hgat_attpool {dtype} {f}: shape {out[f].shape} or not finite")
        conv.use_fused_dense(False)
        ref = pred(list(series))
        conv.use_fused_dense(True)
        errs = []
        tol = TOL["float32"] if dtype == "float32" else BRAIN_BF16_TOL
        for f in fields:
            err, scale = float(np.abs(out[f] - ref[f]).max()), float(np.abs(ref[f]).max())
            errs.append(f"{f} {err:.3e} (max|ref| {scale:.3e})")
            if not err <= tol * scale:
                fail(f"hgat_attpool {dtype} {f}: terms route vs plain route max|err| {err:.3e}"
                     f" > {tol}·{scale:.3e}")
        sbatch = pred.collate(list(series[:BRAIN_BATCH]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred.forward(sbatch)
        torch.cuda.synchronize()
        fwd_gb = torch.cuda.max_memory_allocated() / 1e9
        fwd_ms = median_ms(torch, lambda: pred.forward(sbatch), 5)
        fwd_dev, fwd_busy, fwd_top = device_profile(torch, lambda: pred.forward(sbatch), 2,
                                                    top=6)
        print(f"[brain] hgat_attpool {dtype} served {BRAIN_SUBJECTS} subjects in batches of "
              f"{BRAIN_BATCH}: forward {fwd_ms:.3f} ms (median of 5; device {fwd_dev:.3f} ms, "
              f"busy {100 * fwd_busy:.1f}%; peak device memory {fwd_gb:.2f} GB), "
              f"{BRAIN_BATCH / fwd_ms * 1e3:.1f} subjects/s; "
              f"{per_fwd} terms launches a forward, 0 fused; terms vs plain route max|err| "
              f"{'; '.join(errs)} (bound {tol} of max|ref|) [{card}]", flush=True)
        print(f"[brain] hgat_attpool {dtype} forward, top device operations: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms x{n:g}" for name, ms, n in fwd_top), flush=True)
        conv.use_fused_dense(False)
        try:
            plain_fwd_ms = median_ms(torch, lambda: pred.forward(sbatch), 5)
            plain_fwd_dev, plain_fwd_busy, _ = device_profile(
                torch, lambda: pred.forward(sbatch), 2)
        finally:
            conv.use_fused_dense(True)

        if dtype == "float32":
            # the shared layout against the flat one (ELL kernel), eval forward
            model.eval()
            ell.reset_launch_counts()
            with torch.inference_mode():
                out_s = model(batch)
                out_f = model(flat)
            per_flat = sum(int(m.weight.shape[0]) - 1 for m in model.modules()
                           if isinstance(m, conv.LaguerreConv))
            if dict(ell.LAUNCHES) != {"spmm_ell": per_flat, "spmm_ell_bwd": 0}:
                fail(f"hgat_attpool flat forward launched {dict(ell.LAUNCHES)}, want {per_flat}")
            errs = []
            for f, a, b in zip(fields, out_s, out_f):
                a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
                errs.append(f"{f} {float(np.abs(a - b).max()):.3e}")
                if a.shape != b.shape or not np.allclose(a, b, rtol=2e-4, atol=2e-5):
                    fail(f"hgat_attpool {f}: the shared and the flat layout disagree "
                         f"(max|err| {float(np.abs(a - b).max()):.3e})")
            print(f"[brain] hgat_attpool float32 shared vs flat (ELL) eval forward, "
                  f"{BRAIN_BATCH} subjects: max|err| {'; '.join(errs)} (rtol 2e-4, atol "
                  f"2e-5); ELL launches {per_flat}", flush=True)
            ell_total = dict(ell.LAUNCHES)

        # one warm-up step, in which cuDNN's autotuner times Inception1D's
        # convolutions (its trials hold the largest workspace of the phase)
        trainer = Trainer(copy.deepcopy(model), cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [trainer.train_step(batch)]
        torch.cuda.synchronize()
        warm_gb = torch.cuda.max_memory_allocated() / 1e9
        lg.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses += [trainer.train_step(batch) for _ in range(BRAIN_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / BRAIN_STEPS
        step_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = dict(lg.LAUNCHES)
        # the edge init conv reads the raw FC input, which needs no gradient
        want = {**none, "laguerre_terms_dense": per_fwd * BRAIN_STEPS,
                "laguerre_terms_dense_bwd": (per_fwd - 1) * BRAIN_STEPS}
        if counts != want:
            fail(f"hgat_attpool {dtype} training launched {counts}, expected {want}")
        for name in total:
            total[name] += counts[name]
        values = [float(v) for v in losses]
        if not all(np.isfinite(values)):
            fail(f"hgat_attpool {dtype}: non-finite loss {values}")
        for name, m in trainer.model.named_modules():
            if isinstance(m, conv.LaguerreConv) and not bool((m.weight.grad != 0).any()):
                fail(f"hgat_attpool {dtype}: {name}.weight has no gradient")
        val_loss, r = trainer.evaluate([batch])
        step_dev, step_busy, step_top = device_profile(
            torch, lambda: trainer.train_step(batch), 1, top=6)
        print(f"[brain] hgat_attpool {dtype} trained 1 + {BRAIN_STEPS} steps at batch "
              f"{BRAIN_BATCH}: step {step_ms:.3f} ms (mean of {BRAIN_STEPS} after the warm-up; "
              f"device {step_dev:.3f} ms, busy {100 * step_busy:.1f}%; peak device memory "
              f"{step_gb:.2f} GB, {warm_gb:.2f} GB in the warm-up); loss {values[0]:.5f} -> "
              f"{values[-1]:.5f}, eval loss {val_loss:.5f}, Pearson r {r:.4f}; launches a "
              f"step {per_fwd} terms + {per_fwd - 1} terms backward, 0 fused [{card}]",
              flush=True)
        print(f"[brain] hgat_attpool {dtype} step, top device operations: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms x{n:g}" for name, ms, n in step_top), flush=True)
        del trainer
        torch.cuda.empty_cache()

        # the same forward and steps on the plain route (no hand kernel), the
        # end-to-end comparison for the folded terms kernel
        trainer = Trainer(copy.deepcopy(model), cfg)
        conv.use_fused_dense(False)
        try:
            trainer.train_step(batch)
            lg.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(BRAIN_STEPS):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            plain_step_ms = (time.perf_counter() - t0) * 1e3 / BRAIN_STEPS
            plain_step_gb = torch.cuda.max_memory_allocated() / 1e9
            plain_dev, plain_busy, _ = device_profile(
                torch, lambda: trainer.train_step(batch), 1)
        finally:
            conv.use_fused_dense(True)
        if dict(lg.LAUNCHES) != none:
            fail(f"hgat_attpool {dtype} plain route launched {dict(lg.LAUNCHES)}")
        print(f"[brain] hgat_attpool {dtype} plain route against the terms kernel: forward "
              f"{plain_fwd_ms:.3f} ms (device {plain_fwd_dev:.3f} ms, busy "
              f"{100 * plain_fwd_busy:.1f}%) against {fwd_ms:.3f} (device {fwd_dev:.3f}); "
              f"step {plain_step_ms:.3f} ms (device {plain_dev:.3f} ms, busy "
              f"{100 * plain_busy:.1f}%; peak device memory {plain_step_gb:.2f} GB) against "
              f"{step_ms:.3f} (device {step_dev:.3f}) [{card}]", flush=True)
        del trainer
        torch.cuda.empty_cache()

    # abcd_attpool at its preset widths, one batch per dtype
    mid = levels[1]
    for dtype in ("float32", "bfloat16"):
        model, _ = presets.abcd_attpool(**ABCD_MODEL, nodes_per_graph=mid.num_nodes,
                                        edges_per_graph=mid.num_edges, compute_dtype=dtype,
                                        seed=0)
        n_abcd = sum(1 for m in model.modules()
                     if isinstance(m, conv.LaguerreConv) and m.weight.shape[0] > 1)
        pred = BrainPredictor(model, levels[:2], pools[:1], batch_size=BRAIN_BATCH)
        lg.reset_launch_counts()
        out = pred(list(series[:BRAIN_BATCH]))
        counts = dict(lg.LAUNCHES)
        if counts != {**none, "laguerre_terms_dense": n_abcd}:
            fail(f"abcd_attpool {dtype} launched {counts}, expected {n_abcd} terms launches")
        for name in total:
            total[name] += counts[name]
        if set(out) != {"pred"} or out["pred"].shape != (BRAIN_BATCH, 1) or not np.isfinite(
                out["pred"]).all():
            fail(f"abcd_attpool {dtype}: outputs {[(k, v.shape) for k, v in out.items()]}")
        sbatch = pred.collate(list(series[:BRAIN_BATCH]))
        fwd_ms = median_ms(torch, lambda: pred.forward(sbatch), 5)
        print(f"[brain] abcd_attpool {dtype} ((2,2,2), (64,128,256), K = 2, one pool) served "
              f"{BRAIN_BATCH} subjects: forward {fwd_ms:.3f} ms, {n_abcd} terms launches, 0 "
              f"fused [{card}]", flush=True)
    return total, ell_total, summary


def write_zinc_raw(np, root: str, seed: int = 0) -> None:
    """ZINC-format raw splits, the files PyG's ZINC dataset downloads:
    ``{split}.pickle``, a list of dicts of torch tensors ``atom_type`` [n]
    (0-27), ``bond_type`` [n, n] (0, or 1-3 on a bond) and
    ``logP_SA_cycle_normalized`` [1].  Seeded connected molecules: a random
    tree of 9-38 atoms plus up to three ring bonds; the label a function of
    the size, the rings and the atom types plus noise, so that training has
    something to learn."""
    import os
    import pickle

    import torch

    rng = np.random.default_rng(seed)
    for split, count in ZINC_SPLITS.items():
        mols = []
        for _ in range(count):
            n = int(rng.integers(ZINC_ATOMS[0], ZINC_ATOMS[1] + 1))
            child = np.arange(1, n)
            parent = rng.integers(0, child)
            adj = np.zeros((n, n), np.int64)
            adj[child, parent] = adj[parent, child] = rng.integers(1, 4, n - 1)
            rings = 0
            for _ in range(int(rng.integers(0, 4))):
                a, b = rng.integers(0, n, 2)
                if a != b and adj[a, b] == 0:
                    adj[a, b] = adj[b, a] = 1
                    rings += 1
            atoms = rng.integers(0, 28, n)
            y = 0.08 * (n - 23) - 0.6 * rings + 1.5 * float(np.mean(atoms < 4)) + 0.2 * rng.normal()
            mols.append(dict(atom_type=torch.from_numpy(atoms), bond_type=torch.from_numpy(adj),
                             logP_SA_cycle_normalized=torch.tensor([y], dtype=torch.float32)))
        with open(os.path.join(root, f"{split}.pickle"), "wb") as f:
            pickle.dump(mols, f)


def sample_arrays(sample):
    """Every array of a GraphSample, in a fixed order."""
    out = [sample.x_t, sample.x_s, sample.y]
    for lvl in sample.levels:
        out += [getattr(lvl, f.name) for f in dataclasses.fields(lvl)]
    return out


def batch_tensors(batch, prefix=""):
    """{path: array or tensor} of every array field of a batch."""
    out = {}
    if dataclasses.is_dataclass(batch):
        for f in dataclasses.fields(batch):
            out.update(batch_tensors(getattr(batch, f.name), f"{prefix}.{f.name}"))
    elif isinstance(batch, (tuple, list)):
        for i, v in enumerate(batch):
            out.update(batch_tensors(v, f"{prefix}[{i}]"))
    elif batch is not None and not isinstance(batch, (int, float, bool)):
        out[prefix] = batch
    return out


def with_ell_forms(batch):
    """A flat batch whose L0/L1 also carry their ELL forms, which the ELL
    SpMM kernel reads (``collate(with_ell=True)`` on a loader's batch)."""
    from hl_hgat_tpu_torch.complex.build import coo_to_ell

    def ell_of(m):
        cols, vals = coo_to_ell(m.rows, m.cols, m.vals, m.shape[0])
        return dataclasses.replace(m, ell_cols=cols, ell_vals=vals)

    return dataclasses.replace(batch, levels=tuple(
        dataclasses.replace(lv, l0=ell_of(lv.l0), l1=ell_of(lv.l1)) for lv in batch.levels))


def data_phase(torch, np, lg, ell, card):
    """Phase 11: the data pipeline feeding full-width zinc_pyr training.
    Returns the Laguerre and the ELL launches of its main-path runs."""
    import tempfile

    from hl_hgat_tpu_torch.complex.augment import pe_sign_flip
    from hl_hgat_tpu_torch.complex.compact import inflate, maybe_inflate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.fast_collate import FlatSamples, collate_packed_fast
    from hl_hgat_tpu_torch.data.ingest import load_samples
    from hl_hgat_tpu_torch.data.loader import BucketedLoader
    from hl_hgat_tpu_torch.data.prefetch import prefetch
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    # ---- ingest: raw files -> load_samples.  The train split is parsed
    # only; the val split is parsed and cached, then read from the cache,
    # which must give the parse's arrays.
    with tempfile.TemporaryDirectory(prefix="zinc_raw_") as root:
        t0 = time.perf_counter()
        write_zinc_raw(np, root)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = load_samples("zinc", root, "train", keig=ZINC_LOAD_KEIG, cache=False)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        val = load_samples("zinc", root, "val", keig=ZINC_LOAD_KEIG)
        t_val = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = load_samples("zinc", root, "val", keig=ZINC_LOAD_KEIG)
        t_read = time.perf_counter() - t0
    for split, got in (("train", train), ("val", val), ("val cache", cached)):
        if len(got) != ZINC_SPLITS[split.split()[0]]:
            fail(f"ingest: {split} holds {len(got)} samples")
    for a, b in zip(val, cached):
        for u, v in zip(sample_arrays(a), sample_arrays(b)):
            if not np.array_equal(u, v):
                fail("ingest: the val cache differs from the parse")
    print(f"[data] ingest: {len(train)} train + {len(val)} val ZINC-format molecules "
          f"({sum(s.num_nodes for s in train)} train atoms), raw files written in "
          f"{t_write:.2f} s; load_samples parse {t_train:.2f} s train, parse + cache "
          f"{t_val:.2f} s val; val cache read {t_read:.2f} s, equal to the parse (host)",
          flush=True)

    # ---- the loader's transfers: the first batch on the card against the native dense batch
    flat = FlatSamples(train)
    bs, caps = DATA_LOADER["batch_size"], dict(node_cap=DATA_LOADER["node_cap"],
                                                edge_cap=DATA_LOADER["edge_cap"])
    order = np.arange(len(train))
    np.random.default_rng(0).shuffle(order)  # the loader's first epoch (seed 0)
    idx = order[:bs]
    f32_first = {}
    for transfer in ("dense", "compact", "derived"):
        loader = BucketedLoader(train, transfer=transfer, **DATA_LOADER)
        t0 = time.perf_counter()
        batches = list(itertools.islice(loader, DATA_COLLATE_BATCHES))
        host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        first = batches[0]
        f32_first[transfer] = first
        if not np.array_equal(np.asarray(first.y), flat.y_graph[idx]):
            fail(f"{transfer}: the first batch is not the loader's first draw")
        nbytes = statistics.mean(
            sum(v.nbytes for v in batch_tensors(b).values()) for b in batches)
        moved_ms = median_ms(torch, lambda: first.to("cuda"), 5)
        on_card = maybe_inflate(first.to("cuda"))
        torch.cuda.synchronize()
        off_card = [path for path, t in batch_tensors(on_card).items()
                    if not (isinstance(t, torch.Tensor) and t.device.type == "cuda")]
        if off_card:
            fail(f"{transfer}: {off_card} not on the card after the transfer and inflate")
        nb = on_card.x_t.shape[0]
        ref_host = collate_packed_fast(flat, idx, num_blocks=nb, **caps)
        ref = batch_tensors(ref_host.to("cuda"))
        got = batch_tensors(on_card)
        if set(got) != set(ref):
            fail(f"{transfer}: fields {sorted(got)} against {sorted(ref)}")
        for path, want in ref.items():
            have = got[path]
            if path.endswith((".l0", ".l1")) and transfer == "derived":
                if not torch.equal(have != 0, want != 0):
                    fail(f"derived {path}: sparsity pattern differs from the host's")
                rel = float(((have - want).abs() / want.abs().clamp_min(1e-30)).max())
                if not rel <= DERIVED_RTOL:
                    fail(f"derived {path}: {rel:.3e} relative from the host's values")
            elif have.dtype != want.dtype or not torch.equal(have, want):
                fail(f"{transfer} {path}: not bit-equal to the native dense batch")
        inflate_ms = inflate_dev = None
        if transfer != "dense":
            moved = first.to("cuda")
            inflate_ms = median_ms(torch, lambda: inflate(moved), 10)
            inflate_dev = device_ms(torch, lambda: inflate(moved), 10)
        else:
            reps = len(batches)  # full batches, no filler
            t0 = time.perf_counter()
            numpy_batches = [collate_dense_packed([train[j] for j in order[i * bs:(i + 1) * bs]],
                                                  num_blocks=batches[i].x_t.shape[0], **caps)
                             for i in range(reps)]
            numpy_ms = (time.perf_counter() - t0) * 1e3 / reps
            ours = batch_tensors(first)
            for path, want in batch_tensors(numpy_batches[0]).items():
                if ours[path].dtype != want.dtype or not np.array_equal(ours[path], want):
                    fail(f"native collate {path} differs from collate_dense_packed's")
        print(f"[data] transfer {transfer}: host collate {host_ms:.3f} ms a batch"
              + (f" (NumPy collate_dense_packed {numpy_ms:.3f} ms)" if transfer == "dense" else "")
              + f", {nbytes / 1e6:.3f} MB a batch host->device ({moved_ms:.3f} ms), {nb} blocks"
              + (f"; inflate on the card {inflate_ms:.3f} ms, device {inflate_dev:.4f} ms"
                 if inflate_ms is not None else "")
              + f"; first batch equal to the native dense batch"
              + (f" (L0/L1 within {DERIVED_RTOL:g} relative)" if transfer == "derived" else "")
              + f" [{card}]", flush=True)
    bf16 = next(iter(BucketedLoader(train, transfer="derived", feature_dtype="bfloat16",
                                    **DATA_LOADER)))
    got, ref = inflate(bf16.to("cuda")), inflate(f32_first["derived"].to("cuda"))
    for name in ("x_t", "x_s"):
        have, want = getattr(got, name), getattr(ref, name).to(torch.bfloat16)
        if have.dtype != torch.bfloat16 or not torch.equal(have.view(torch.int16),
                                                            want.view(torch.int16)):
            fail(f"bfloat16 {name} cast on the host differs from the cast on the card")
    print("[data] bfloat16 features cast on the host: bit-equal to the float32 batch cast on "
          "the card", flush=True)

    # ---- training: full-width zinc_pyr through Trainer.fit, derived transfer
    launches = {name: 0 for name in lg.LAUNCHES}
    none = dict(launches)
    trainers = {}
    for dtype in ("float32", "bfloat16"):
        model, _ = presets.zinc_pyr(compute_dtype=dtype, seed=0)
        kw = dict(transfer="derived", feature_dtype=dtype, **DATA_LOADER)
        train_loader = BucketedLoader(train, **kw)
        val_loader = BucketedLoader(val, shuffle=False, **kw)
        trainer = Trainer(model, TrainerConfig(**DATA_TRAINER))
        # fit asks for the val batches once the train epoch's loss is read
        # back: the stamps between the two calls time each train epoch
        stamps = []

        def stamped(loader, what):
            stamps.append((what, time.perf_counter()))
            return loader

        lg.reset_launch_counts()
        trainer.fit(lambda: stamped(train_loader, "train"), lambda: stamped(val_loader, "val"),
                    epochs=DATA_EPOCHS, verbose=False)
        torch.cuda.synchronize()
        counts = dict(lg.LAUNCHES)
        steps, evals = DATA_EPOCHS * len(train_loader), DATA_EPOCHS * len(val_loader)
        want = {**none, "laguerre_dense_fused": 18 * (steps + evals),
                "laguerre_dense_fused_bwd": 18 * steps}
        if counts != want:
            fail(f"{dtype} fit launched {counts}, expected {want} (18 + 18 a step, 18 an eval)")
        for name in launches:
            launches[name] += counts[name]
        hist = trainer.history
        values = [r[k] for r in hist for k in ("train_loss", "val_loss", "val_metric")]
        if len(hist) != DATA_EPOCHS or not all(np.isfinite(values)):
            fail(f"{dtype} fit: history {hist}")
        if not hist[1]["train_loss"] < hist[0]["train_loss"]:
            fail(f"{dtype} fit: train loss did not fall: {hist[0]['train_loss']} -> "
                 f"{hist[1]['train_loss']}")
        epoch_s = [hist[0]["time"], hist[1]["time"] - hist[0]["time"]]
        if [w for w, _ in stamps] != ["train", "val"] * DATA_EPOCHS:
            fail(f"{dtype} fit asked for the batches as {[w for w, _ in stamps]}")
        train_s = [b[1] - a[1] for a, b in zip(stamps[::2], stamps[1::2])]
        batch = next(iter(train_loader))
        dev_ms, busy, _ = device_profile(torch, lambda: trainer.train_step(batch), 3)
        print(f"[data] {dtype} fit: {DATA_EPOCHS} epochs of {len(train_loader)} steps + "
              f"{len(val_loader)} val batches, prefetch 2: epoch {epoch_s[0]:.2f} s, "
              f"{epoch_s[1]:.2f} s ({len(train_loader) / epoch_s[1]:.2f} steps/s with the "
              f"val pass), train part {train_s[0]:.2f} s, {train_s[1]:.2f} s; train loss "
              f"{hist[0]['train_loss']:.5f} -> "
              f"{hist[1]['train_loss']:.5f}, val MAE {hist[0]['val_metric']:.5f} -> "
              f"{hist[1]['val_metric']:.5f}; 18 + 18 fused launches a step; a profiled step "
              f"(transfer, inflate, flips, step): device {dev_ms:.3f} ms, busy "
              f"{100 * busy:.1f} % [{card}]", flush=True)
        trainers[dtype] = (trainer, train_loader, train_s)
    trainer, train_loader, train_s = trainers["float32"]
    t0 = time.perf_counter()
    trainer.train_epoch(prefetch(train_loader, 0))  # reads the loss back: synchronized
    no_prefetch = time.perf_counter() - t0
    print(f"[data] float32 train epoch ({len(train_loader)} steps): prefetch 0 {no_prefetch:.2f} "
          f"s, against {train_s[-1]:.2f} s with prefetch 2 in the fit's last epoch [{card}]",
          flush=True)

    # ---- a step with flips on equals a step with flips off on a pre-flipped batch
    batch = f32_first["derived"]
    flip_cfg = dict(DATA_TRAINER, seed=5)
    plain_cfg = {k: v for k, v in flip_cfg.items() if not k.startswith("pe_flip")}
    on = Trainer(copy.deepcopy(trainer.model), TrainerConfig(**flip_cfg))
    offs = [Trainer(copy.deepcopy(trainer.model), TrainerConfig(**plain_cfg)) for _ in range(2)]
    g = torch.Generator(device="cuda").manual_seed(5)
    pre = inflate(batch.to("cuda"))
    pre = pre.replace(x_t=pe_sign_flip(pre.x_t, num_static=1, generator=g))
    pre = pre.replace(x_s=pe_sign_flip(pre.x_s, num_static=1, generator=g))
    losses = [on.train_step(batch)] + [t.train_step(pre) for t in offs]
    params = [dict(t.model.named_parameters()) for t in [on] + offs]
    same = [torch.equal(losses[0], losses[i]) and all(
        torch.equal(params[0][k], params[i][k]) for k in params[0]) for i in (1, 2)]
    twice = torch.equal(losses[1], losses[2]) and all(
        torch.equal(params[1][k], params[2][k]) for k in params[1])
    if twice and not same[0]:
        fail("a step with PE flips differs from the step on the pre-flipped batch")
    if not twice:  # the card's own step-to-step spread bounds the difference
        spread = max(float((params[1][k] - params[2][k]).abs().max()) for k in params[1])
        diff = max(float((params[0][k] - params[1][k]).abs().max()) for k in params[0])
        if not diff <= 2 * spread:
            fail(f"flip step differs by {diff:.3e}, two equal steps by {spread:.3e}")
    print(f"[data] PE flips in the step against a pre-flipped batch: loss "
          f"{float(losses[0]):.6f} / {float(losses[1]):.6f}, bit-equal {same[0]} (two plain "
          f"steps bit-equal {twice})", flush=True)

    # ---- the flat layout: the val split through the coo loader on the ELL kernel
    kw = dict(batch_size=bs, shuffle=False, pad_final=False)
    packed = torch.cat([trainer.eval_step(b)[0] for b in BucketedLoader(
        val, transfer="derived", **DATA_LOADER | kw)])
    flat_loader = BucketedLoader(val, layout="coo", **kw)
    ell.reset_launch_counts()
    flat_pred = torch.cat([trainer.eval_step(with_ell_forms(b))[0] for b in flat_loader])
    torch.cuda.synchronize()
    ell_counts = dict(ell.LAUNCHES)
    if ell_counts != {"spmm_ell": 80 * len(flat_loader), "spmm_ell_bwd": 0}:
        fail(f"flat eval launched {ell_counts}, expected 80 a forward")
    err = float((flat_pred - packed).abs().max())
    if flat_pred.shape != (len(val), 1) or not err <= CROSS_LAYOUT_ATOL:
        fail(f"flat vs packed val predictions: shape {tuple(flat_pred.shape)}, max|err| {err}")
    print(f"[data] val split through the coo loader on the ELL kernel ({len(flat_loader)} "
          f"batches, {ell_counts['spmm_ell']} launches): max|flat - packed| {err:.3e}",
          flush=True)
    print(f"[data] phase 11 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches, ell_counts


def checkpoint_phase(torch, np, lg, card):
    """Phase 12: checkpoint and resume through ``run.main`` at the CLI's zinc
    recipe (2 epochs with ``--ckpt_every 1``, ``--resume`` to 3 against 3
    straight), the full state saved and loaded, ``--test`` on the shipped
    converted weights against the JAX CLI's loss and metric,
    ``Predictor.from_checkpoint`` serving them in both dtypes against the
    JAX forward, and ``import_hgcnn`` on the card against the reference
    fixture.  Returns the Laguerre launches of its main-path runs."""
    import contextlib
    import io
    import os
    import tempfile

    from hl_hgat_tpu_torch import run
    from hl_hgat_tpu_torch.complex.build import build_complex
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph
    from hl_hgat_tpu_torch.nn.conv import LaguerreConv
    from hl_hgat_tpu_torch.serving import Predictor
    from hl_hgat_tpu_torch.train import checkpoint as ckpt
    from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
    from hl_hgat_tpu_torch.utils.torch_import import import_hgcnn

    t_phase = time.perf_counter()
    total = {name: 0 for name in lg.LAUNCHES}
    none = {name: 0 for name in lg.LAUNCHES}

    def cli(argv):
        """``run.main`` in process: (result, stdout, seconds, launches)."""
        buf = io.StringIO()
        lg.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = run.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(lg.LAUNCHES)
        for name in total:
            total[name] += counts[name]
        for line in buf.getvalue().splitlines():
            print(f"[ckpt]   {line}", flush=True)
        return res, buf.getvalue(), seconds, counts

    # a. train with checkpoints, resume, compare with a straight run
    n_val = 512 // 10
    steps = -(-(512 - n_val) // 128)  # train batches an epoch (the last filled)

    def expect(epochs):
        return {**none, "laguerre_dense_fused": 18 * (steps + 1) * epochs,
                "laguerre_dense_fused_bwd": 18 * steps * epochs}

    restore_s = []
    maybe_restore = Trainer.maybe_restore

    def timed_restore(self, *a, **kw):
        t0 = time.perf_counter()
        out = maybe_restore(self, *a, **kw)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        return out

    Trainer.maybe_restore = timed_restore
    try:
        with tempfile.TemporaryDirectory() as tmp:
            resumed_dir, straight_dir = os.path.join(tmp, "resumed"), os.path.join(tmp, "straight")
            _, _, s_two, c_two = cli(CKPT_CLI + ["--epochs", "2", "--save_dir", resumed_dir])
            latest = os.path.join(resumed_dir, "zinc_fold0", "latest")
            size = os.path.getsize(os.path.join(latest, "state.pt"))
            meta = ckpt.load_metadata(latest)
            resumed, out, s_res, c_res = cli(CKPT_CLI + ["--epochs", "3", "--resume", "1",
                                                         "--save_dir", resumed_dir])
            if "resumed from epoch 2" not in out:
                fail("the resumed run did not print 'resumed from epoch 2'")
            straight, _, s_str, c_str = cli(CKPT_CLI + ["--epochs", "3",
                                                        "--save_dir", straight_dir])
            for tag, got, epochs in (("2 epochs", c_two, 2), ("resume to 3", c_res, 1),
                                     ("3 straight", c_str, 3)):
                if got != expect(epochs):
                    fail(f"checkpoint phase {tag} launched {got}, expected {expect(epochs)} "
                         f"(18 + 18 a step, 18 an eval forward)")
            if set(meta) != {"epoch", "metric", "lr", "best_metric"} or meta["epoch"] != 2:
                fail(f"latest/meta.json after 2 epochs: {meta}")
            h_res, h_str = resumed[0]["history"], straight[0]["history"][-1]
            if [h["epoch"] for h in h_res] != [3]:
                fail(f"the resumed run ran epochs {[h['epoch'] for h in h_res]}")
            errs = {k: abs(h_res[0][k] - h_str[k]) / abs(h_str[k])
                    for k in ("train_loss", "val_loss")}
            print(f"[ckpt] zinc_pyr CLI, {steps} steps an epoch at batch 128: 2 epochs "
                  f"{s_two:.2f} s, --resume to 3 {s_res:.2f} s (maybe_restore {restore_s[0]:.3f} "
                  f"s), 3 straight {s_str:.2f} s; epoch 3 train loss {h_res[0]['train_loss']:.7f} "
                  f"resumed vs {h_str['train_loss']:.7f} straight (rel {errs['train_loss']:.2e}), "
                  f"val loss {h_res[0]['val_loss']:.7f} vs {h_str['val_loss']:.7f} (rel "
                  f"{errs['val_loss']:.2e}); 18 + 18 launches a step [{card}]", flush=True)
            if not all(e <= RESUME_RTOL for e in errs.values()):
                fail(f"epoch 3 resumed differs from the straight run: {errs}")

            # the full state: load into a fresh trainer, save it again
            # the CLI's model for these flags (synthetic zinc: 16 input columns)
            model, _ = run.make_model(run.build_argparser().parse_args(CKPT_CLI), in_t=16,
                                      in_s=16)
            trainer = Trainer(model, TrainerConfig())
            t0 = time.perf_counter()
            sections = ckpt.restore_checkpoint(latest, trainer)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = ckpt.save_checkpoint(os.path.join(tmp, "again"), trainer)
            save_s = time.perf_counter() - t0
            reread = ckpt.load_state(os.path.join(tmp, "again"))
            for key, val in sections["model"].items():
                if not torch.equal(reread["model"][key], val):
                    fail(f"the state saved again differs at {key}")
            print(f"[ckpt] full state (sections {sorted(sections)}): {size / 2**20:.2f} MiB; "
                  f"load into a trainer on the card {load_s:.3f} s, save {save_s:.3f} s "
                  f"({os.path.getsize(again) / 2**20:.2f} MiB) [{card}]", flush=True)
    finally:
        Trainer.maybe_restore = maybe_restore

    # b. --test on the shipped weights against the JAX CLI's numbers
    ref = np.load(os.path.join(SHIPPED, "jax_reference.npz"))
    res, _, s_test, c_test = cli(SHIPPED_TEST)
    if c_test != {**none, "laguerre_dense_fused": 18}:
        fail(f"--test launched {c_test}, expected 18 fused (one eval batch)")
    loss, metric = res[0]["loss"], res[0]["metric"]
    rl = abs(loss - float(ref["cli_loss"])) / abs(float(ref["cli_loss"]))
    rm = abs(metric - float(ref["cli_metric"])) / abs(float(ref["cli_metric"]))
    print(f"[ckpt] --test on {SHIPPED}: loss {loss:.7f} (JAX CLI {float(ref['cli_loss']):.7f}, "
          f"rel {rl:.2e}), metric {metric:.7f} (JAX {float(ref['cli_metric']):.7f}, rel "
          f"{rm:.2e}), {s_test:.2f} s [{card}]", flush=True)
    if not (rl <= CLI_RTOL and rm <= CLI_RTOL):
        fail("--test on the shipped weights disagrees with the JAX CLI")

    # c. serve the shipped weights
    samples = zinc_like_samples(np.random.default_rng(0), BATCH_GRAPHS, keig=16)
    jax_out = ref["out"]
    scale = float(np.abs(jax_out).max())
    width = samples[0].x_t.shape[1]
    for dtype in ("float32", "bfloat16"):
        model, _ = presets.zinc_pyr(keig=SHIPPED_KEIG, in_t=width, in_s=width,
                                    compute_dtype=dtype, seed=0)
        pred = Predictor.from_checkpoint(model, SHIPPED, batch_size=BATCH_GRAPHS)
        lg.reset_launch_counts()
        out = pred(samples)
        counts = dict(lg.LAUNCHES)
        if counts != {**none, "laguerre_dense_fused": 18}:
            fail(f"serving the shipped weights ({dtype}) launched {counts}")
        for name in total:
            total[name] += counts[name]
        err = float(np.abs(out - jax_out).max())
        if out.shape != jax_out.shape or not err <= TOL[dtype] * scale:
            fail(f"served shipped weights {dtype}: max|err| {err:.3e} against the JAX "
                 f"forward (max|ref| {scale:.3e})")
        batch = pred.collate(samples)
        fwd_ms = median_ms(torch, lambda: pred.forward(batch), 10)
        calls = {}
        for transfer in ("dense", "derived"):
            p = Predictor(pred.model, batch_size=BATCH_GRAPHS, transfer=transfer)
            p(samples)  # warm
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                p(samples)
                times.append((time.perf_counter() - t0) * 1e3)
            calls[transfer] = statistics.median(times)
        print(f"[serve] shipped zinc_fold0 {dtype}, {BATCH_GRAPHS} graphs: forward incl. "
              f"inflate {fwd_ms:.3f} ms; Predictor call (loader, transfer, forward, readback) "
              f"dense {calls['dense']:.1f} ms, derived {calls['derived']:.1f} ms; vs the JAX "
              f"forward max|err| {err:.3e} (max|ref| {scale:.3e}); 18 fused launches "
              f"[{card}]", flush=True)

    # d. the reference importer on the card
    fx = dict(np.load(IMPORT_FIXTURE))
    n_off = np.concatenate([[0], np.cumsum(fx["num_node1"].astype(int))])
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    ei = fx["in/edge_index"]
    fsamples = []
    for i in range(len(n_off) - 1):
        cols = (ei[0] >= n_off[i]) & (ei[0] < n_off[i + 1])
        fsamples.append(build_complex(
            ei[:, cols] - n_off[i], int(n_off[i + 1] - n_off[i]),
            x_t=fx["in/x_t"][n_off[i]:n_off[i + 1]], x_s=fx["in/x_s"][e_off[i]:e_off[i + 1]],
            y=np.zeros(1)))
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), k=3, init_k=3, deg_eps=0.0)
    model = HLHGCNNGraph(cfg, fx["in/x_t"].shape[1], fx["in/x_s"].shape[1], mlp_channels=(),
                         num_classes=1).cuda()
    _, report = import_hgcnn(model, {k[3:]: v for k, v in fx.items() if k.startswith("sd/")})
    batch = collate_dense_packed(fsamples).to("cuda")
    n_convs = sum(1 for m in model.modules() if isinstance(m, LaguerreConv))
    lg.reset_launch_counts()
    with torch.inference_mode():
        out = model.eval()(batch).float().cpu().numpy()
    counts = dict(lg.LAUNCHES)
    if counts != {**none, "laguerre_dense_fused": n_convs}:
        fail(f"the imported fixture model launched {counts}, expected {n_convs} fused")
    for name in total:
        total[name] += counts[name]
    err, fscale = float(np.abs(out - fx["out"]).max()), float(np.abs(fx["out"]).max())
    print(f"[ckpt] import_hgcnn({IMPORT_FIXTURE}): {len(report.consumed)} tensors, "
          f"{len(report.dropped)} dropped; forward on the card vs the reference's out max|err| "
          f"{err:.3e} (max|ref| {fscale:.3e}), {n_convs} fused launches [{card}]", flush=True)
    if not err <= TOL["float32"] * fscale:
        fail("the imported fixture model disagrees with the reference's output")
    took = time.perf_counter() - t_phase
    print(f"[ckpt] phase 12 took {took:.1f} s [{card}]", flush=True)
    if took > CKPT_PHASE_S:
        fail(f"phase 12 took {took:.1f} s, over {CKPT_PHASE_S} s")
    return total


def print_laguerre_summary(summary, names, card):
    for name in names:
        for dtype in ("float32", "bfloat16"):
            agg = summary[(name, dtype)]
            print(f"[kernel] {name} {dtype} per step: kernel {agg['ms']:.4f} ms, plain "
                  f"{agg['plain_ms']:.4f} ms, bound {agg['bound']:.4f} ms, max|err| "
                  f"{agg['err']:.3e} [{card}]", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="GPU smoke run of the PyTorch port")
    ap.add_argument("--kernels-only", nargs="?", const="all",
                    choices=("all", "resident", "band", "ell"),
                    help="build and check the kernels only (phases 2, 2b, 4 and 6; "
                         "'resident': 2 and 4, blocks of at most 128 rows; 'band': 2b, "
                         "blocks over 128 rows; 'ell': 6), no result line")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    import numpy as np

    from hl_hgat_tpu_torch import cuda_build
    from hl_hgat_tpu_torch.complex.compact import maybe_inflate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.ops import ell_spmm as ell
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg
    from hl_hgat_tpu_torch.serving import Predictor

    # f32 means f32: the JAX reference runs Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ---------------------------------------------------------
    import threading

    from hl_hgat_tpu_torch import native

    t0 = time.perf_counter()
    host = {}
    # the host library (g++) builds while nvcc runs; a failure raises below
    builder = threading.Thread(target=lambda: host.update(
        seconds=native.build(), lib=native.load()))
    builder.start()
    logs = cuda_build.build()
    print(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    builder.join()
    if host.get("lib") is None:
        fail("the host library did not build or load (its error is printed above)")
    print(f"[native] {native.library_path().name} built with g++ in {host['seconds']:.2f} s "
          f"({'found built' if host['seconds'] == 0 else 'compiled now'})", flush=True)
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
    for lib, wanted in MMA_KERNELS.items():
        if lib not in cuda_build.SOURCES:  # an older tree, run for comparison
            continue
        counts = cuda_build.tensor_core_opcodes(lib)
        for kernel, n in sorted(counts.items()):
            print(f"[build] {lib}: {n} tensor-core opcodes in {kernel}", flush=True)
        for name in wanted:
            for bf16 in (False, True):
                found = [n for kernel, n in counts.items()
                         if name in kernel and ("bfloat16" in kernel) == bf16]
                if not found or min(found) == 0:
                    fail(f"{name} ({'bfloat16' if bf16 else 'float32'}) holds no "
                         f"tensor-core opcode: {found}")

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

    def pooled_setup():
        """The pooled path's samples, model, packed batch on the card and the
        512-row L1 blocks of the same samples."""
        from hl_hgat_tpu_torch.data.synthetic import pooled_like_samples

        t0 = time.perf_counter()
        pooled_samples = pooled_like_samples(np.random.default_rng(5), POOLED_GRAPHS)
        batch = collate_dense_packed(pooled_samples, edge_cap=256)
        wide = collate_dense_packed(pooled_samples, edge_cap=512)
        print(f"[data] pooled: {POOLED_GRAPHS} graphs, {int(batch.level0.edge_mask.sum())} real "
              f"edges, {batch.x_t.shape[0]} blocks, rows by level (nodes, edges) "
              f"{[(lvl.l0.shape[1], lvl.l1.shape[1]) for lvl in batch.levels]}; 512-row "
              f"packing {wide.x_s.shape[0]} blocks ({time.perf_counter() - t0:.2f} s host)",
              flush=True)
        model, _ = presets.cifar10sp_attpool(seed=0)
        return (pooled_samples, model, batch.to("cuda"),
                torch.as_tensor(wide.levels[0].l1).cuda())

    if args.kernels_only:
        if args.kernels_only in ("all", "resident"):
            summary = check_kernels(torch, np, lg, l_blocks, conv_shapes, 1)
            print_laguerre_summary(summary, list(lg.LAUNCHES), card)
        if args.kernels_only in ("all", "band"):
            _, pmodel, pbatch, wide_l1 = pooled_setup()
            band_phase(torch, np, lg, conv, pmodel, pbatch, wide_l1, card)
        if args.kernels_only in ("all", "ell"):
            on_card, _ = flat_batches(torch, np, samples)
            print_ell_summary(check_ell(torch, np, ell, ell_cases(model32, on_card["zinc"],
                                                                  on_card["node"]),
                                        np.random.default_rng(4), card), card)
        print("[kernels-only] done, no result line", flush=True)
        return 0
    summary = check_kernels(torch, np, lg, l_blocks, conv_shapes, 1)
    pooled_samples, pooled_model, pooled_batch, wide_l1 = pooled_setup()
    band_summary = band_phase(torch, np, lg, conv, pooled_model, pooled_batch, wide_l1, card)

    # ---- 3. the serving path ----------------------------------------------
    launches = {name: 0 for name in lg.LAUNCHES}
    none = {name: 0 for name in lg.LAUNCHES}
    served = {}  # the fused route's predictions per dtype
    expect = {"plain": none,
              "terms": {**none, "laguerre_terms_dense": 16},
              "fused": {**none, "laguerre_dense_fused": 18}}
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=BATCH_GRAPHS)
        # the loader's derived batch, inflated on the card; its block count
        # is the packing's rounded up by the loader's pinned caps
        batch = maybe_inflate(pred.collate(samples))
        blocks = batch.x_t.shape[0]
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
            print(f"[serve] {dtype} {route}: forward {fwd_ms[route]:.3f} ms on {blocks} blocks "
                  f"({g} packed, rounded up by the loader), "
                  f"{BATCH_GRAPHS / fwd_ms[route] * 1e3:.1f} graphs/s, "
                  f"{real_edges / fwd_ms[route] * 1e3:.4e} real edges/s; "
                  f"Predictor call incl. loader and inflate {e2e:.1f} ms [{card}]", flush=True)
        conv.use_fused_dense(True)
        conv.use_terms_kernel(False)
        served[dtype] = outs["fused"]
        ref = outs["plain"]
        scale = float(np.abs(ref).max())
        for route in ("fused", "terms"):
            err = float(np.abs(outs[route] - ref).max())
            print(f"[serve] {dtype} {route} vs plain route: max|err| {err:.3e} "
                  f"(max|ref| {scale:.3e})", flush=True)
            if not err <= TOL[dtype] * scale:
                fail(f"{dtype} {route} route disagrees with the plain route")
        if dtype == "float32":
            packed_pred32 = outs["fused"]
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

    # ---- 6-7. the flat layout: kernel 5, three models ----------------------
    ell_summary, ell_launches = flat_phase(torch, np, model32, samples, packed_pred32, card)
    for name, n in ell_launches.items():
        if n == 0:
            fail(f"{name} was never launched on the flat path")

    # ---- 3b. zinc_pyr on 256-row L1 blocks ----------------------------------
    for name, n in zinc_wide_phase(torch, np, lg, model32, samples, served, card).items():
        launches[name] += n

    # ---- 8. the pooled path: cifar10sp_attpool served and trained ----------
    pooled_launches, pooled_ell = pooled_phase(torch, np, lg, ell, pooled_model,
                                               pooled_samples, card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if pooled_launches[name] == 0:
            fail(f"{name} was never launched on the pooled path")
    for name, n in pooled_launches.items():
        launches[name] += n
    for name, n in pooled_ell.items():
        ell_launches[name] += n

    # ---- 9. the large-graph layout: TSP-500 trained, served edge by edge ---
    tsp_launches, tsp_ell = tsp_phase(torch, np, lg, ell, card)
    if tsp_launches["laguerre_dense_fused"] == 0 or tsp_ell["spmm_ell"] == 0:
        fail(f"the TSP phase launched {tsp_launches} {tsp_ell}")
    for name, n in tsp_launches.items():
        launches[name] += n
    for name, n in tsp_ell.items():
        ell_launches[name] += n

    # ---- 10. the brain family on the shared-skeleton layout ------------------
    brain_launches, brain_ell, brain_summary = brain_phase(torch, np, lg, ell, card)
    for name in ("laguerre_terms_dense", "laguerre_terms_dense_bwd"):
        if brain_launches[name] == 0:
            fail(f"{name} was never launched on the brain path")
    for name, n in brain_launches.items():
        launches[name] += n
    for name, n in brain_ell.items():
        ell_launches[name] += n

    # ---- 11. the data pipeline feeding full-width zinc_pyr training ----------
    data_launches, data_ell = data_phase(torch, np, lg, ell, card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if data_launches[name] == 0:
            fail(f"{name} was never launched on the data pipeline's path")
    for name, n in data_launches.items():
        launches[name] += n
    for name, n in data_ell.items():
        ell_launches[name] += n

    # ---- 12. checkpoint, resume, --test and serving of the shipped weights ---
    ckpt_launches = checkpoint_phase(torch, np, lg, card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if ckpt_launches[name] == 0:
            fail(f"{name} was never launched on the checkpoint phase's path")
    for name, n in ckpt_launches.items():
        launches[name] += n

    # ---- 13. result lines -------------------------------------------------
    replaces = {
        "laguerre_dense_fused": "hl_hgat_tpu/ops/pallas_hodge.py:93",
        "laguerre_terms_dense": "hl_hgat_tpu/ops/pallas_hodge.py:285",
        "laguerre_dense_fused_bwd": "hl_hgat_tpu/ops/pallas_hodge.py:123",
        "laguerre_terms_dense_bwd": "hl_hgat_tpu/ops/pallas_hodge.py:293",
    }
    sources = {name: "hl_hgat_tpu_torch/csrc/laguerre_dense"
               + ("_bwd.cu" if name.endswith("_bwd") else ".cu") for name in replaces}
    print_laguerre_summary(summary, replaces, card)
    for name in replaces:
        b32 = band_summary[(name, "float32")]
        print(f"[kernel] {name} float32 per pooled pass over 128 rows: {b32['ms']:.4f} ms, "
              f"bound {b32['bound']:.4f} ms [{card}]", flush=True)
    for name in ("laguerre_terms_dense", "laguerre_terms_dense_bwd"):
        for dtype in ("float32", "bfloat16"):
            agg = brain_summary[(name, dtype)]
            print(f"[kernel] {name} {dtype} per brain forward on the folded level-0 and "
                  f"level-1 L1: {agg['ms']:.4f} ms, plain {agg['plain_ms']:.4f} ms, bound "
                  f"{agg['bound']:.4f} ms, max|err| {agg['err']:.3e} [{card}]", flush=True)
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
    print_ell_summary(ell_summary, card)
    e32 = ell_summary["float32"]
    kernels.append({
        "name": "spmm_ell", "route": "cuda",
        "source": "hl_hgat_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "hl_hgat_tpu/ops/pallas_spmm.py:38",
        "launches": ell_launches["spmm_ell"] + ell_launches["spmm_ell_bwd"],
        "max_abs_err": e32["err"], "ms": e32["ms"], "plain_ms": e32["plain_ms"],
        "bound_ms": e32["bound"],
        "bound_by": "operations" if e32["by_ops"] >= e32["by_bytes"] else "bytes",
        "library_ms": e32["library_ms"],
        "dtype": "float32", "per": "one flat zinc_pyr training step at batch 384",
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
