#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``hl_hgat_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [resident|band|ell]   # the kernel phases only
    python3 chip_smoke.py --parallel-only   # build, then phase 13 only
    python3 chip_smoke.py --analysis-only   # build, then phase 14 only

1. Builds the CUDA kernels from ``hl_hgat_tpu_torch/csrc`` (nvcc, sm_90a)
   and, at the same time, the host library ``csrc/hlhgat_native.cpp`` and
   ``csrc/hlhgat_pack.cpp`` (g++; a ``[native]`` line with its build
   seconds), prints the card's name and power limit, and reads the three
   Laguerre libraries with ``cuobjdump -sass``: every Laguerre kernel, fused and
   terms, forward and backward, must hold tensor-core opcodes (HMMA /
   HGMMA), and every kernel of the band library, step and products, wgmma
   (HGMMA) and no HMMA, in float32 (3xTF32) and in bfloat16, in each
   instantiation (``band_bar_kernel`` has two: g resident and streamed).
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
   L1 blocks at K = 4, C = F = 64 and 128, a ragged case (G = 3, S =
   129, C = 45, F = 37, K = 4), and wide outputs (G = 8, S = 256, C = 64,
   K = 4, F = 576, 640, 1472 and 1600: ``g W_kᵀ`` with g's rows resident
   and streamed, in each dtype); then the terms kernels (2 and 4) at brain
   scale, held as phase 10 holds them: every conv on phase 10's folded
   level-0 L1 (the Shen-268 pyramid, S = 8997, among them C = 512, K = 4)
   and on the brain demo's (S = 7047, K = 3).  Each shape prints the band
   step kernel's launch (``[band]`` lines: grid, tile, threads, shared
   memory, registers, CTAs an SM, waves) and, beside each terms case, a
   yardstick that the port never calls: one step's ``torch.matmul(L, T)``
   in the same dtype (cuBLAS, default precision) times K - 1, the product
   alone.  Each fused case also prints the device time of every kernel
   that one forward and one backward call launch (steps, products,
   reduce), each product beside its bound and one ``torch.matmul`` of the
   same product, and the product kernels' launches.
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
   (cuDNN's autotuner picks Inception1D's algorithms), one counted step
   (14 terms + 13 terms-backward launches) and BRAIN_STEPS timed
   ``Trainer(task="brain")`` steps per dtype; forward and step ms with the
   busy share, peak device memory and the top device operations, beside
   the same forward and steps
   on the plain route; forwards and steps on a batch already seen prepare
   no band operator in either dtype; ``abcd_attpool`` at its preset widths
   served once per dtype; a ``[band]`` line for every band shape the phase
   launched (phase 14 prints its own).
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
13. The parallel package (``[dp]`` and ``[gp]`` lines, within
   PARALLEL_PHASE_S; every time "on one card, ranks sharing it"): one
   ``DataParallelTrainer`` step of full-width ``zinc_pyr`` on the 384
   graphs at world 1 on NCCL in this process, per dtype, against
   ``Trainer.train_step`` from the same copy (TOL, bit-equal yes/no, 18 + 18
   fused launches, both step times); two gloo ranks spawned on the one card
   (NCCL refuses two ranks on one device; the kernels are built before they
   start, every rank is joined with a timeout, and each reports its
   launches): a step on the two distinct halves of the 384 graphs and one on
   identical halves, each held to a single process's step on the mean
   gradient and mean BN statistics (TRAIN_LEAF_TOL; parameters equal across
   ranks) and the averaged gradient that the update read to that mean
   gradient (TRAIN_LEAF_TOL, TRAIN_NORM_TOL; so at world 1), then ``run.main`` with ``--dp 2`` in the ranks at phase 12's
   recipe, 2 epochs and ``--resume`` to 3 against 3 straight (finite
   losses; epoch 3 within RESUME_RTOL; the recipe's targets are N(0, 1)
   draws, so its L1 loss starts at its floor and need not fall); then the
   graph-parallel model of ``examples/gp_brain.py`` on the Shen-268
   skeleton and its MLGC level over two gloo ranks (the halo exchange staged
   through host memory) against the single-process model on the flat layout
   on the card (forward TOL; one Adam step, loss rtol 1e-4, parameters rtol
   1e-3 / atol 1e-5 on every leaf; the averaged gradient that the update
   read against the single-process gradient, GP_GRAD_RTOL / GP_GRAD_ATOL;
   also for the same backbone with a linear head, the one whose loss
   reaches every layer (the gp_brain head's hidden BatchNorm sees one
   graph, so there only the output bias has a gradient): its activations'
   inputs held to the single process's (TOL), the entries that change
   branch listed, and its gradient held against the single-process step
   that takes the graph-parallel step's branches), the halo and
   all-gather bytes of an L1 mat-vec, and
   both step times.  The graph path's products are plain torch: no hand
   kernel runs there.
14. The analysis layer and the three examples (``[analysis]`` lines,
   within ANALYSIS_PHASE_S): ``examples.brain_demo`` at ANALYSIS_DEMO (268
   ROIs, the real Shen-268 parcellation's size; 24 subjects, T = 96, 5
   epochs, batch 8, a 20 % mask): the pyramid's sizes, the host ms of the
   native MLGC matcher against the pure-Python walk, what a band launch
   pays for its operator (the level-0 L1 with padded rows and float32's
   TF32 halves, prepared once for the batch, then a cache lookup; the
   terms route's preparations over its steps, at most one per band
   operator of the train batches); trained from one seeded model on the
   terms-kernel route and on the plain route (per-epoch losses, step ms by
   ``utils.profiling.StepTimer`` synchronized, launches of kernels 2 and 4
   a step with the band ones, none fused; falling epoch losses); at every
   step of the kernel route's run both routes' loss (TOL) and gradient
   (``compare_train_grads``) on its weights; the kernel route's trained
   weights served on both routes (validation predictions and the
   attention matrix within ANALYSIS_TOL of max|ref|); runs trained apart
   with Adam and with SGD beside the plain route run again from the same
   weights (reported); ``trace_context`` around three demo steps (the
   Chrome trace names the resident and band terms kernels);
   ``enable_nan_checks`` (a / a on zeros raises, a demo forward raises
   nothing); the TSP and CIFAR figures' arrays on the card against the CPU
   (TOL); ``examples.gp_brain`` at GP_DEMO over two gloo
   ranks sharing the card (finite losses, equal on both ranks).
15. Prints one ``{"kernels": [...]}`` line (five kernels; launches summed
   over every phase's counted main-path calls, the spawned ranks' included)
   and, last, the ``{"ok": true, ...}`` line.

Launches are counted by the port's recorder (``utils.profiling``,
``launches.<wrapper>``), which is on only around untimed calls (``counting``)
and around the in-process CLI runs of phases 12 and 13, whose seconds say
so; a timed loop runs with it off.

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

import contextlib
import copy
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

# the card's peaks, the benchmark's (float32-accurate work at its fastest is
# three TF32 passes, the fused kernels' 3xTF32, above the 67 TFLOP/s of the
# CUDA cores, so no float32 row can read under its bound)
from portbench.counts import HBM_BYTES_PER_S, PEAK_FLOPS

# the hand kernels' wrappers, as the port's recorder names their launches
# (``launches.<wrapper>``)
LAGUERRE = ("laguerre_dense_fused", "laguerre_terms_dense", "laguerre_dense_fused_bwd",
            "laguerre_terms_dense_bwd")
ELL = ("spmm_ell", "spmm_ell_bwd")
# the kernels that must hold tensor-core opcodes, in both dtypes, and which
# opcodes count: the band library's are wgmma (HGMMA) kernels
MMA_KERNELS = {"laguerre_dense": (("HMMA", "HGMMA"), ("fused_fwd_mma_kernel",
                                                      "terms_fwd_mma_kernel")),
               "laguerre_dense_bwd": (("HMMA", "HGMMA"), ("fused_bwd_dx_mma_kernel",
                                                          "fused_bwd_dw_mma_kernel",
                                                          "terms_bwd_mma_kernel")),
               "laguerre_band": (("HGMMA",), ("band_step_kernel", "band_out_kernel",
                                              "band_bar_kernel", "band_dw_kernel"))}
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
# phase 13: the parallel package.  Data parallelism on zinc_pyr (world 1 on
# NCCL; world 2 on gloo, the ranks sharing the card) and the CLI's --dp 2 at
# phase 12's recipe; the graph-parallel model of examples/gp_brain.py on the
# Shen-268 skeleton over two gloo ranks
DP_CLI = CKPT_CLI + ["--dp", "2"]
GP_MODEL = dict(channels=(2, 2), filters=(32, 64), k=4, init_k=2, pool_locs=(0,), att_locs=(0,),
                act="leaky_relu")
GP_MLP = (64,)
# the head's hidden BatchNorm sees the one graph, so only the output bias of
# that model has a gradient: the gradient rule is held on the same backbone
# with a linear head (GP_PROBE_MLP), whose loss reaches every layer
GP_PROBE_MLP = ()
GP_LR = 1e-3
# one computation's gradient against another's, per entry (the JAX tests' bar)
GP_GRAD_RTOL, GP_GRAD_ATOL = 2e-3, 1e-5
# The linear-head model's gradient is held to that bar against the
# single-process step that takes the graph-parallel step's branch at every
# ReLU and leaky ReLU: the two forwards sum in other orders, and a
# pre-activation within rounding of a kink can land on either side of it,
# which moves the gradient of every layer below it by a whole entry.  The
# pre-activations themselves must agree within TOL of each call's max|ref|,
# so only an entry within rounding of 0 can change branch.
ZERO_GRAD = 1e-6  # share of the largest gradient entry below which a leaf's gradient is rounding
GP_STEPS = 3  # timed steps after the checked one
PARALLEL_PHASE_S = 120
# phase 14: the brain demo at the size of the real Shen-268 parcellation (the
# --rois that --real on sets), its other flags at their defaults (24
# subjects, T = 96, 5 epochs, batch 8, a 20 % mask); kernel route against the
# plain route from the same weights
ANALYSIS_DEMO = ["--real", "off", "--rois", "268"]
ANALYSIS_ROUTES = {"plain": (False, False), "terms": (False, True)}
# The routes are held where one computation meets another on the same
# weights: at every step of the kernel route's run, both routes' loss (TOL)
# and gradient (compare_train_grads) on its weights and batch; and the
# kernel route's trained weights served on both routes (validation
# predictions and the attention matrix within ANALYSIS_TOL of max|ref|).
# Runs trained apart are reported beside the plain route run again from the
# same weights, with the demo's Adam and with plain SGD at ANALYSIS_SGD_LR:
# the card's summation order alone separates two runs of one route (an
# H100 measured 0.13 with Adam, 0.54 with SGD, of an epoch loss within the
# demo's 10 steps)
ANALYSIS_TOL = 1e-3
ANALYSIS_SGD_LR = 1e-2
ANALYSIS_TRACE_STEPS = 3
GP_DEMO = ["--parts", "2", "--steps", "3"]  # two ranks share the card
ANALYSIS_PHASE_S = 90


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


@contextlib.contextmanager
def counting():
    """The port's recorder (``utils.profiling``) on around the block, which
    is an untimed call (a timed one would carry the recorder's profiler
    ranges): yields a dict that holds the block's counter totals once the
    block ends.  The recorder is off and empty afterwards."""
    from hl_hgat_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    counters = {}
    try:
        yield counters
    finally:
        profiling.disable()
        counters.update(profiling.snapshot().counters)
        profiling.reset()


def launched(counters, names=LAGUERRE) -> dict:
    """``{wrapper: launches}`` of the wrappers ``names`` in ``counting``'s
    counters."""
    return {name: counters.get(f"launches.{name}", 0) for name in names}


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


def check_terms_pair(torch, lg, dtype, label, lb, x, dt, count, summary, yardstick=False):
    """The terms forward and backward against their plain versions;
    ``yardstick``: also time one step's product alone as cuBLAS forms it."""
    g, sb, c = x.shape
    k = dt.shape[0]
    nbytes = (g * sb * sb + g * sb * c + k * g * sb * c) * x.element_size()
    flops = 2 * g * sb * sb * c * (k - 1)
    shape = f"{dtype} {label}G={g} S={sb} C={c} K={k}"
    if yardstick and k > 1:
        ms = graph_ms(torch, lambda: torch.matmul(lb, x), KERNEL_CALLS) * (k - 1)
        print(f"[kernel] yardstick {shape}: torch.matmul(L, T) in {dtype} (cuBLAS, default "
              f"precision), K - 1 = {k - 1} products alone, no combine, not called by the "
              f"port: {ms:.4f} ms", flush=True)
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


def empty_summary():
    return {(name, dtype): dict(ms=0.0, plain_ms=0.0, by_bytes=0.0, by_ops=0.0, bound=0.0,
                                err=0.0)
            for name in LAGUERRE for dtype in ("float32", "bfloat16")}


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
    summary = empty_summary()
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


def compare_grads(tag, got, ref, zero_grad, leaf_tol=None, norm_tol=None, cosine=None,
                  prefix="train"):
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
    print(f"[{prefix}] {tag}: worst leaf {worst:.3e} of max|ref| ({where}), whole gradient "
          f"{norm_rel:.3e} of its norm, cosine {cos:.6f}", flush=True)
    if leaf_tol is not None and not worst <= leaf_tol:
        fail(f"{tag}: gradient of {where} is off by {worst:.3e} of max|ref| > {leaf_tol}")
    if norm_tol is not None and not norm_rel <= norm_tol:
        fail(f"{tag}: gradient is off by {norm_rel:.3e} of its norm > {norm_tol}")
    if cosine is not None and not cos >= cosine:
        fail(f"{tag}: cosine {cos:.4f} < {cosine}")


def compare_train_grads(tag, dtype, got, ref, zero_grad, prefix="train"):
    if dtype == "float32":
        compare_grads(tag, got, ref, zero_grad, TRAIN_LEAF_TOL, TRAIN_NORM_TOL, prefix=prefix)
    else:
        compare_grads(tag, got, ref, zero_grad, cosine=TRAIN_BF16_COSINE, prefix=prefix)


def train_phase(torch, np, model32, samples, host_batch, real_edges, card):
    """A first step and TRAIN_STEPS timed steps per dtype and route through
    ``Trainer.train_step``; returns the launches of the first steps, which
    are counted (the timed ones are not)."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig, l1_loss

    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)
    none = dict.fromkeys(LAGUERRE, 0)
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
            with counting() as counters:
                losses = [trainer.train_step(batch)]
                torch.cuda.synchronize()
            counts = launched(counters)
            if counts != per_step[route]:
                fail(f"{dtype} {route} training step launched {counts}, "
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


def flat_task_phase(torch, np, tag, make_model, batch, task, steps, per_step, units,
                    card, skip_grad=()):
    """One flat model on the default (ELL-kernel) route, float32 and
    bfloat16, through ``Trainer``: eval forward (timed), ``steps`` training
    steps (the first apart), launch counts, falling loss, non-zero conv
    gradients.  Returns (the launches of the counted first steps, the
    float32 eval output)."""
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    total = dict.fromkeys(ELL, 0)
    out32 = None
    for dtype in ("float32", "bfloat16"):
        model = make_model(dtype)
        trainer = Trainer(model, TrainerConfig(task=task, lr=1e-3, weight_decay=1e-3,
                                               metric_mode="max"))
        with counting() as counters:
            out, loss = trainer.eval_step(batch)
            torch.cuda.synchronize()
        counts = launched(counters, ELL)
        if counts != {"spmm_ell": per_step[0], "spmm_ell_bwd": 0}:
            fail(f"{tag} {dtype}: eval forward launched {counts}")
        if not bool(torch.isfinite(out).all()) or out.dtype != torch.float32:
            fail(f"{tag} {dtype}: eval output not finite float32")
        if dtype == "float32":
            out32 = out
        fwd_ms = median_ms(torch, lambda: trainer.eval_step(batch), 10)
        with counting() as counters:
            losses = [trainer.train_step(batch)]
            torch.cuda.synchronize()
        counts = launched(counters, ELL)
        want = {"spmm_ell": per_step[0], "spmm_ell_bwd": per_step[1]}
        if counts != want:
            fail(f"{tag} {dtype}: training step launched {counts}, expected {want}")
        for name, m in model.named_modules():
            if isinstance(m, conv.LaguerreConv) and name not in skip_grad:
                if m.weight.grad is None or not bool((m.weight.grad != 0).any()):
                    fail(f"{tag} {dtype}: {name}.weight has no gradient")
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
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
    per-step summary and its launches summed over every counted flat step."""
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
    total = dict.fromkeys(ELL, 0)
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
            with counting() as counters:
                out, _ = trainer.eval_step(batch)
                torch.cuda.synchronize()
            counts = launched(counters, ELL)
            if counts != {"spmm_ell": per_step[route][0], "spmm_ell_bwd": 0}:
                fail(f"flat zinc {dtype} {route}: eval forward launched {counts}")
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
            with counting() as counters:
                losses = [trainer.train_step(batch)]
                torch.cuda.synchronize()
            counts = launched(counters, ELL)
            want = dict(zip(ELL, per_step[route]))
            if counts != want:
                fail(f"flat zinc {dtype} {route}: training step launched {counts}, "
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
        torch, np, "pascalvoc_node",
        lambda dtype: presets.pascalvoc_node(compute_dtype=dtype, seed=0)[0],
        node, "node_classification", TRAIN_STEPS + 1, (36, 36), real["node"], card)
    pad = node.level0.node_mask == 0
    if out.shape != (node.level0.num_nodes, 21) or not bool(pad.any()) or bool(out[pad].any()):
        fail("pascalvoc_node: logits must be [N, 21] and exactly 0 on padded nodes")
    for name in total:
        total[name] += counts[name]

    # ---- 7c. pcqm_link -------------------------------------------------------
    counts, out = flat_task_phase(
        torch, np, "pcqm_link",
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
    summary = empty_summary()
    breakdown = []
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
            print_band_plan(torch, lg, dtype, tag, g, sb, c)
            check_fused_pair(torch, lg, dtype, f"{tag} ", lb, x, w, b, cot, count, summary)
            breakdown.append((dtype, tag, lb, x, w, b, cot))
            if k > 1:
                dt = torch.stack([feats(c) for _ in range(k)])
                check_terms_pair(torch, lg, dtype, f"{tag} ", lb, x, dt, count, summary,
                                 yardstick=True)
    band_breakdowns(torch, breakdown)
    return summary


def band_breakdowns(torch, cases):
    """``band_call_kernels`` for every fused case ``(dtype, tag, l, x, w, b,
    cot)``, in one child process: a process that has opened a few dozen
    ``torch.profiler`` sessions loses the device events of later ones (on
    an H100 the full script's later device-time checks then found none)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "band_cases.pt")
        torch.save([(d, t, *(a.cpu() for a in arrays)) for d, t, *arrays in cases], path)
        child = "import sys, chip_smoke; chip_smoke.band_breakdown_child(sys.argv[1])"
        proc = subprocess.run([sys.executable, "-c", child, path],
                              cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    if proc.returncode != 0:
        fail(f"phase 2b's kernel breakdown exited with {proc.returncode}")


def band_breakdown_child(path: str) -> None:
    import torch

    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype, tag, *arrays in torch.load(path):
        band_call_kernels(torch, lg, dtype, tag, *(a.cuda() for a in arrays))


def kernel_times(torch, fn, calls: int) -> dict[str, float]:
    """Device ms per call of each kernel that ``fn`` launches, by name (the
    name without namespace, template arguments and parameters), from a
    ``torch.profiler`` window over ``calls`` calls."""
    import re

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0.0)
            found = re.match(r"(?:void\s+)?(?:[\w:]*::)?(\w+)",
                             evt.key.replace("(anonymous namespace)::", ""))
            name = found.group(1) if found else evt.key[:48]
            times[name] = times.get(name, 0.0) + us / 1e3 / calls
        if times:
            return times
    fail("the profiler recorded no device time in three traces")


def band_call_kernels(torch, lg, dtype, tag, lb, x, w, b, cot):
    """Phase 2b's breakdown of one fused band call each way: every kernel a
    forward and a backward launch, by name and device time (steps, products,
    reduce); beside each product its bound and a yardstick that the port
    never calls, the same product as one ``torch.matmul`` in the same dtype
    (cuBLAS, default precision): Σ_k T_k W_k as [R, K·C] x [K·C, F] (no
    bias), g W_kᵀ as [R, F] x [F, K·C], T_kᵀ g as [K·C, R] x [R, F] (no db).
    Then the product kernels' launches (``[band]`` plan lines, where the
    tree has them)."""
    g, sb, c = x.shape
    k, _, f = w.shape
    r, es = g * sb, x.element_size()
    shape = f"{dtype} {tag} G={g} S={sb} C={c} F={f} K={k}"
    tcat = lg.laguerre_terms_dense(lb, x, k).permute(1, 2, 0, 3).reshape(r, k * c).contiguous()
    wcat = w.to(x.dtype).reshape(k * c, f)
    g2 = cot.reshape(r, f)

    def bound(nbytes, flops):
        by_bytes = nbytes * es / HBM_BYTES_PER_S * 1e3
        by_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return max(by_bytes, by_ops), "operations" if by_ops >= by_bytes else "bytes"

    flops = 2 * r * k * c * f
    products = {
        "band_out_kernel": (bound(k * r * c + r * f, flops), lambda: torch.matmul(tcat, wcat)),
        "band_bar_kernel": (bound(r * f + k * r * c, flops), lambda: torch.matmul(g2, wcat.t())),
        "band_dw_kernel": (bound(k * r * c + r * f + k * c * f * 4 // es, flops),
                           lambda: torch.matmul(tcat.t(), g2)),
    }
    yard = {name: graph_ms(torch, mm, KERNEL_CALLS) for name, (_, mm) in products.items()}
    for way, fn in (("forward", lambda: lg.laguerre_dense_fused(lb, x, w, b)),
                    ("backward", lambda: lg.laguerre_dense_fused_bwd(lb, x, w, cot))):
        times = kernel_times(torch, fn, KERNEL_CALLS)
        parts = []
        for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
            line = f"{name} {ms:.4f} ms"
            if name in products:
                (b_ms, by), _ = products[name]
                line += (f" (bound {b_ms:.4f} ms, {by}; one torch.matmul {yard[name]:.4f} ms, "
                         f"not called by the port)")
            parts.append(line)
        print(f"[band] {shape} {way} kernels: {'; '.join(parts)}; all "
              f"{sum(times.values()):.4f} ms", flush=True)
    for name in getattr(lg, "BAND_PRODUCTS", ()):
        p = lg.band_product_plan(name, g, sb, c, f, k, x.dtype)
        print(f"[band] {shape}: {name} grid {p['grid']}, tile {p['tile'][0]} rows x "
              f"{p['tile'][1]} columns, {p['threads']} threads, {p['smem']} B shared, "
              f"{p['regs']} registers, {p['ctas_per_sm']} CTAs an SM, {p['waves']:.2f} waves",
              flush=True)


def print_band_plan(torch, lg, dtype, tag, g, s, c):
    """How the band step kernel launches at this shape (a tree without the
    plan prints nothing)."""
    if not hasattr(lg, "band_step_plan"):
        return
    p = lg.band_step_plan(g, s, c, getattr(torch, dtype))
    print(f"[band] {dtype} {tag} G={g} S={s} C={c}: band_step_kernel grid {p['grid']}, tile "
          f"{p['tile'][0]} rows x {p['tile'][1]} channels, {p['threads']} threads, "
          f"{p['smem']} B shared, {p['regs']} registers, {p['ctas_per_sm']} CTAs an SM, "
          f"{p['waves']:.2f} waves", flush=True)


def print_band_shapes(torch, lg, phase):
    """The band step kernel's launch at every band shape the phase ran
    (``lg.BAND_SHAPES``, gathered since the phase cleared it)."""
    for g, s, c, td in sorted(lg.BAND_SHAPES, key=lambda t: (str(t[3]), t[1], t[2], t[0])):
        print_band_plan(torch, lg, str(td).removeprefix("torch."), f"{phase} launched", g, s, c)


def brain_band_cases(torch, np, conv):
    """The terms kernels' band cases at brain scale: ``(tag, L1 [1, S, S]
    float32 on the card, K, folded C, launches a forward)`` for every conv
    on the level-0 L1 of phase 10 (the Shen-268 pyramid, hgat_attpool at
    BRAIN_MODEL, BRAIN_BATCH subjects) and of phase 14's brain demo (its
    recipe at ANALYSIS_DEMO, a train batch)."""
    from hl_hgat_tpu_torch.examples import brain_demo
    from hl_hgat_tpu_torch.models import presets

    levels, _, _, host, _ = brain_data(np, with_flat=False)
    batch = host.to("cuda")
    final, fine = levels[2], levels[0]
    model, _ = presets.hgat_attpool(
        **BRAIN_MODEL, nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
        fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges, seed=0)
    cases = [("brain level 0 L1 folded", batch.levels[0].l1.float(), k, c, n)
             for lv, op, _, k, c, n in brain_conv_cases(torch, conv, model, batch)
             if lv == 0 and op == "L1"]
    args = brain_demo.build_argparser().parse_args(ANALYSIS_DEMO)
    init = brain_demo.init_stage(args, log=lambda m: None)
    demo_batch = brain_demo.batches(init.train, args.batch_size, "cuda")[0]
    demo_model, _ = brain_demo.build_model(init, "cuda")
    cases += [("brain demo level 0 L1 folded", demo_batch.levels[0].l1.float(), k, c, n)
              for lv, op, _, k, c, n in brain_conv_cases(torch, conv, demo_model, demo_batch)
              if lv == 0 and op == "L1"]
    if not any(lap.shape[1] == 8997 and c == 512 for _, lap, _, c, _ in cases):
        fail(f"phase 2b: no brain case at S = 8997, C = 512: "
             f"{[(t, lap.shape[1], k, c) for t, lap, k, c, _ in cases]}")
    return cases


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
    path the 512-row L1 blocks ``wide_l1`` at K = 4, C = F = 64 and 128, and
    their leading 129 x 129 in 3 blocks at C = 45, F = 37, K = 4, and 8 of
    them cut to 256 rows at C = 64, K = 4 and wide F: the widest F whose
    rows of g a CTA of ``band_bar_kernel`` holds in shared memory (576
    float32, 1472 bfloat16) and one past it in each dtype."""
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
    # ragged: rows, channels and columns none of which is a tile's multiple
    cases.append(("ragged", wide_l1[:3, :129, :129].contiguous(), 4, 45, 37, 0))
    wide_f = wide_l1[:8, :256, :256].contiguous()
    cases += [("wide_f", wide_f, 4, 64, f, 0) for f in (576, 640, 1472, 1600)]
    return cases


def band_phase(torch, np, lg, conv, model32, pooled_batch, wide_l1, card):
    """Phase 2b: the band kernels at the pooled path's shapes and at 512
    rows, then the terms kernels at brain scale (phase 10's and the brain
    demo's folded level-0 L1); returns the summary over one pooled
    forward's (backward's) launches over 128 rows."""
    cases = band_cases(torch, np, conv, model32, pooled_batch, wide_l1)
    summary = check_band_kernels(torch, np, lg, cases, 2)
    for name in LAGUERRE:
        for dtype in ("float32", "bfloat16"):
            agg = summary[(name, dtype)]
            print(f"[kernel] {name} {dtype} blocks over 128 rows, per pooled pass: kernel "
                  f"{agg['ms']:.4f} ms, plain {agg['plain_ms']:.4f} ms, bound "
                  f"{agg['bound']:.4f} ms, max|err| {agg['err']:.3e} [{card}]", flush=True)
    brain = empty_summary()
    for tag, lap, k, c, count in brain_band_cases(torch, np, conv):
        s = lap.shape[1]
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            rng = np.random.default_rng([3, s, k, c])
            x = torch.from_numpy(rng.standard_normal((1, s, c)).astype(np.float32)).cuda().to(td)
            dt = torch.from_numpy(rng.standard_normal((k, 1, s, c)).astype(np.float32)
                                  ).cuda().to(td)
            print_band_plan(torch, lg, dtype, tag, 1, s, c)
            check_terms_pair(torch, lg, dtype, f"{tag} ", lap.to(td), x, dt, count, brain,
                             yardstick=True)
            del x, dt
        del lap
        torch.cuda.empty_cache()
    return summary


def zinc_wide_phase(torch, np, model32, samples, served, card):
    """Phase 3b: zinc_pyr served through ``Predictor(edge_cap=256)`` (256-row
    L1 blocks, the band kernels) in both dtypes, held against the 128-row
    packing's predictions ``served[dtype]``; then ZINC_WIDE_STEPS training
    steps at ``edge_cap=256`` in float32, the first loss against the
    128-row packing's.  Returns the launches counted (the forwards and the
    first step at 256)."""
    from hl_hgat_tpu_torch.complex.compact import maybe_inflate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import Predictor
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    total = dict.fromkeys(LAGUERRE, 0)
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.zinc_pyr(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=BATCH_GRAPHS, edge_cap=256)
        batch = maybe_inflate(pred.collate(samples))  # the loader's derived batch, inflated
        if batch.levels[0].l1.shape[1] != 256:
            fail(f"Predictor(edge_cap=256) packed L1 blocks of {batch.levels[0].l1.shape[1]}")
        with counting() as counters:
            out = pred(samples)
        counts = launched(counters)
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
        with counting() as counters:
            losses = [trainer.train_step(batch)]
            torch.cuda.synchronize()
        counts = launched(counters)
        want = {**dict.fromkeys(LAGUERRE, 0), "laguerre_dense_fused": 18,
                "laguerre_dense_fused_bwd": 18}
        if counts != want:
            fail(f"zinc_pyr edge_cap={cap} training step launched {counts}, expected {want}")
        t0 = time.perf_counter()
        losses += [trainer.train_step(batch) for _ in range(ZINC_WIDE_STEPS - 1)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (ZINC_WIDE_STEPS - 1)
        values = [float(v) for v in losses]
        if not all(np.isfinite(values)):
            fail(f"zinc_pyr edge_cap={cap}: non-finite loss {values}")
        firsts[cap] = values[0]
        if cap == 256:
            for name in total:
                total[name] += counts[name]
        print(f"[train] zinc_pyr float32 edge_cap={cap}: {ZINC_WIDE_STEPS} steps, "
              f"{step_ms:.3f} ms a step (first excluded), 18 + 18 launches a step, loss "
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


def pooled_phase(torch, np, model32, samples, card):
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
    total = dict.fromkeys(LAGUERRE, 0)
    cfg = TrainerConfig(task="classification", lr=1e-3, weight_decay=1e-3, metric_mode="max")
    preds32 = None
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.cifar10sp_attpool(
            compute_dtype=dtype, seed=0)[0]
        pred = Predictor(model, batch_size=POOLED_GRAPHS, edge_cap=256)
        batch = maybe_inflate(pred.collate(samples))  # the loader's derived batch, inflated
        with counting() as counters:
            out = pred(samples)
        counts = launched(counters)
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
        with counting() as counters:
            losses = [trainer.train_step(batch)]
            torch.cuda.synchronize()
        counts = launched(counters)
        want = {**dict.fromkeys(LAGUERRE, 0), "laguerre_dense_fused": per_fwd,
                "laguerre_dense_fused_bwd": per_fwd}
        if counts != want:
            fail(f"cifar10sp_attpool {dtype}: training step launched {counts}, expected {want}")
        for name, m in trainer.model.named_modules():
            if isinstance(m, conv.LaguerreConv) and not bool((m.weight.grad != 0).any()):
                fail(f"cifar10sp_attpool {dtype}: {name}.weight has no gradient")
        t0 = time.perf_counter()
        for _ in range(POOLED_STEPS - 1):
            losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (POOLED_STEPS - 1)
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
    with counting() as counters, torch.inference_mode():
        out = model32(flat)
        torch.cuda.synchronize()
    ell_counts = launched(counters, ELL)
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


def tsp_phase(torch, np, card):
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
    total = dict.fromkeys(LAGUERRE, 0)
    ell_total = dict.fromkeys(ELL, 0)
    none = dict.fromkeys(LAGUERRE, 0)
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
        with counting() as warm:
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
        with counting() as rest:
            aug = Trainer(copy.deepcopy(model), dataclasses.replace(cfg, tsp_aug_prob=0.75))
            aug_losses = [aug.train_step(batch) for _ in range(TSP_STEPS)]
            val_loss, f1 = trainer.evaluate([batch])
        warm, rest = launched(warm, LAGUERRE + ELL), launched(rest, LAGUERRE + ELL)
        hand = {name: warm[name] + rest[name] for name in warm}
        if any(hand.values()):
            fail(f"tsp {dtype}: the banded layout launched {hand}; it takes the plain recurrence")
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
            with counting() as counters:
                out_f = model(flat).float().reshape(-1).cpu().numpy()[flat_real]
        ell_counts = launched(counters, ELL)
        if ell_counts != {"spmm_ell": per_flat, "spmm_ell_bwd": 0}:
            fail(f"tsp {dtype}: the flat forward launched {ell_counts}, want {per_flat}")
        for name in ell_total:
            ell_total[name] += ell_counts[name]
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
        with counting() as counters:
            outs = pred(serve)
        counts = launched(counters)
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


def brain_phase(torch, np, lg, card):
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

    lg.BAND_SHAPES.clear()
    levels, pools, series, host, flat_host = brain_data(np)
    batch, flat = host.to("cuda"), flat_host.to("cuda")
    final, fine = levels[2], levels[0]
    widths = dict(nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
                  fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges)

    # kernels 2 and 4 on the folded L1 shapes of levels 0 and 1
    model32, _ = presets.hgat_attpool(**BRAIN_MODEL, **widths, seed=0)
    cases = brain_conv_cases(torch, conv, model32, batch)
    per_fwd = sum(n for *_, n in cases)
    summary = empty_summary()
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

    none = dict.fromkeys(LAGUERRE, 0)
    total = dict(none)
    fields = ("pred", "latent", "node_att", "edge_att")
    shapes = {"pred": (1,), "latent": (BRAIN_MODEL["mlp_channels"][-1],),
              "node_att": (fine.num_nodes,), "edge_att": (fine.num_edges,)}
    cfg = TrainerConfig(task="brain", lr=1e-4, weight_decay=1e-4, metric_mode="max")
    for dtype in ("float32", "bfloat16"):
        model = model32 if dtype == "float32" else presets.hgat_attpool(
            **BRAIN_MODEL, **widths, compute_dtype=dtype, seed=0)[0]
        pred = BrainPredictor(model, levels, pools, batch_size=BRAIN_BATCH)
        with counting() as counters:
            out = pred(list(series))
        counts = launched(counters)
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
        # the batch's operators (in bfloat16 their casts) were prepared by
        # the forward above: a second forward, and the timed ones, find them
        # all in the caches
        with counting() as counters:
            pred.forward(sbatch)
            torch.cuda.synchronize()
        fwd_prep = counters.get("prepared.band_operator", 0)
        fwd_ms = median_ms(torch, lambda: pred.forward(sbatch), 5)
        if fwd_prep:
            fail(f"hgat_attpool {dtype}: forwards on a batch already seen prepared {fwd_prep} "
                 "band operators again")
        fwd_dev, fwd_busy, fwd_top = device_profile(torch, lambda: pred.forward(sbatch), 2,
                                                    top=6)
        print(f"[brain] hgat_attpool {dtype} served {BRAIN_SUBJECTS} subjects in batches of "
              f"{BRAIN_BATCH}: forward {fwd_ms:.3f} ms (median of 5; device {fwd_dev:.3f} ms, "
              f"busy {100 * fwd_busy:.1f}%; peak device memory {fwd_gb:.2f} GB), "
              f"{BRAIN_BATCH / fwd_ms * 1e3:.1f} subjects/s; "
              f"{per_fwd} terms launches a forward, 0 fused, band operators prepared again "
              f"{fwd_prep}; terms vs plain route max|err| "
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
            with counting() as counters, torch.inference_mode():
                out_s = model(batch)
                out_f = model(flat)
            ell_total = launched(counters, ELL)
            per_flat = sum(int(m.weight.shape[0]) - 1 for m in model.modules()
                           if isinstance(m, conv.LaguerreConv))
            if ell_total != {"spmm_ell": per_flat, "spmm_ell_bwd": 0}:
                fail(f"hgat_attpool flat forward launched {ell_total}, want {per_flat}")
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

        # one warm-up step, in which cuDNN's autotuner times Inception1D's
        # convolutions (its trials hold the largest workspace of the phase)
        trainer = Trainer(copy.deepcopy(model), cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [trainer.train_step(batch)]
        torch.cuda.synchronize()
        warm_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with counting() as counters:
            losses.append(trainer.train_step(batch))
            torch.cuda.synchronize()
        counts = launched(counters)
        step_prep = counters.get("prepared.band_operator", 0)
        if step_prep:
            fail(f"hgat_attpool {dtype}: a step on the warm-up's batch prepared "
                 f"{step_prep} band operators again")
        # the edge init conv reads the raw FC input, which needs no gradient
        want = {**none, "laguerre_terms_dense": per_fwd,
                "laguerre_terms_dense_bwd": per_fwd - 1}
        if counts != want:
            fail(f"hgat_attpool {dtype} training step launched {counts}, expected {want}")
        t0 = time.perf_counter()
        losses += [trainer.train_step(batch) for _ in range(BRAIN_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / BRAIN_STEPS
        step_gb = torch.cuda.max_memory_allocated() / 1e9
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
        print(f"[brain] hgat_attpool {dtype} trained 2 + {BRAIN_STEPS} steps at batch "
              f"{BRAIN_BATCH}: step {step_ms:.3f} ms (mean of {BRAIN_STEPS} after the warm-up "
              f"and a counted step; "
              f"device {step_dev:.3f} ms, busy {100 * step_busy:.1f}%; peak device memory "
              f"{step_gb:.2f} GB, {warm_gb:.2f} GB in the warm-up); loss {values[0]:.5f} -> "
              f"{values[-1]:.5f}, eval loss {val_loss:.5f}, Pearson r {r:.4f}; launches a "
              f"step {per_fwd} terms + {per_fwd - 1} terms backward, 0 fused; band operators "
              f"prepared again {step_prep} [{card}]",
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
            with counting() as counters:
                trainer.train_step(batch)
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
        if launched(counters) != none:
            fail(f"hgat_attpool {dtype} plain route launched {launched(counters)}")
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
        with counting() as counters:
            out = pred(list(series[:BRAIN_BATCH]))
        counts = launched(counters)
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
    print_band_shapes(torch, lg, "phase 10")
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


def data_phase(torch, np, card):
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
    launches = dict.fromkeys(LAGUERRE, 0)
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

        trainer.fit(lambda: stamped(train_loader, "train"), lambda: stamped(val_loader, "val"),
                    epochs=DATA_EPOCHS, verbose=False)
        torch.cuda.synchronize()
        # the epochs are timed: one more step and one eval on a loader batch are counted
        batch = next(iter(train_loader))
        with counting() as counters:
            trainer.train_step(batch)
            trainer.eval_step(batch)
            torch.cuda.synchronize()
        counts = launched(counters)
        want = {**none, "laguerre_dense_fused": 18 + 18, "laguerre_dense_fused_bwd": 18}
        if counts != want:
            fail(f"{dtype} a loader step and eval launched {counts}, expected {want} "
                 "(18 + 18 a step, 18 an eval)")
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
    with counting() as counters:
        flat_pred = torch.cat([trainer.eval_step(with_ell_forms(b))[0] for b in flat_loader])
        torch.cuda.synchronize()
    ell_counts = launched(counters, ELL)
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


def checkpoint_phase(torch, np, card):
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
    total = dict.fromkeys(LAGUERRE, 0)
    none = dict.fromkeys(LAGUERRE, 0)

    def cli(argv):
        """``run.main`` in process, its launches counted: (result, stdout,
        seconds with the recorder on, launches)."""
        buf = io.StringIO()
        with counting() as counters:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = run.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = launched(counters)
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
            print(f"[ckpt] zinc_pyr CLI, {steps} steps an epoch at batch 128, launches counted "
                  f"(the recorder on): 2 epochs "
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
        with counting() as counters:
            out = pred(samples)
        counts = launched(counters)
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
    with counting() as counters, torch.inference_mode():
        out = model.eval()(batch).float().cpu().numpy()
    counts = launched(counters)
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


# ---------------------------------------------------------------------------
# phase 13: the parallel package, ranks sharing the card
# ---------------------------------------------------------------------------


def zero_grad_leaves(grads) -> set:
    """The leaves whose reference gradient is zero to rounding (the biases
    that a BatchNorm on batch statistics follows): no entry above ZERO_GRAD
    of the largest entry of the whole gradient (host arrays)."""
    top = max(float(abs(g).max()) for g in grads.values())
    return {k for k, g in grads.items() if float(abs(g).max()) <= ZERO_GRAD * top}


def capture_grads(trainer) -> dict:
    """A dict that the trainer's next optimizer step fills, before it
    updates anything, with every parameter's gradient as a float32 host
    array: what the update reads, after the ranks averaged it."""
    seen: dict = {}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    step = trainer.optimizer.step

    def first_step(*args, **kwargs):
        if not seen:
            for group in trainer.optimizer.param_groups:
                for p in group["params"]:
                    seen[names[id(p)]] = p.grad.detach().float().cpu().numpy().copy()
        return step(*args, **kwargs)

    trainer.optimizer.step = first_step
    return seen


def state_error(got, ref, zero_grad) -> tuple[float, str]:
    """Worst leaf of two state dicts: max|got − ref| of the leaf's max|ref|
    (``zero_grad`` leaves and all-zero ones: of the largest entry of the
    state), and where."""
    top = max(float(abs(r).max()) for r in ref.values())
    worst, where = 0.0, ""
    for name, r in ref.items():
        scale = float(abs(r).max())
        if name in zero_grad or scale == 0.0:
            scale = top
        rel = float(abs(got[name].astype("float64") - r).max()) / scale
        if rel >= worst:
            worst, where = rel, name
    return worst, where


def _host_state(model):
    """The model's state dict as float32 host arrays (copies)."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in model.state_dict().items()}


def _mean_step(torch, cfg, model, halves):
    """One Adam step on the mean of the halves' gradients with the mean of
    their BatchNorm statistics, in this process: (state dict after it, mean
    loss, the mean gradient as host arrays)."""
    from hl_hgat_tpu_torch.train import Trainer

    grads, bufs, losses = [], [], []
    for half in halves:
        t = Trainer(copy.deepcopy(model), cfg)
        losses.append(float(t._compute_gradients(half)))
        grads.append([p.grad.clone() for p in t.model.parameters()])
        bufs.append([b.clone() for b in t.model.buffers()])
    mean = Trainer(copy.deepcopy(model), cfg)
    for i, p in enumerate(mean.model.parameters()):
        p.grad = sum(g[i] for g in grads) / len(grads)
    mean_grads = {n: p.grad.float().cpu().numpy().copy()
                  for n, p in mean.model.named_parameters()}
    mean.optimizer.step()
    with torch.no_grad():
        for i, b in enumerate(mean.model.buffers()):
            b.copy_(sum(x[i] for x in bufs) / len(bufs))
    return _host_state(mean.model), sum(losses) / len(losses), mean_grads


def dp_rank(rank: int, world: int, halves, save_dir: str) -> dict:
    """One of two gloo ranks on the shared card: the data-parallel step of
    full-width zinc_pyr on distinct halves (case 1) and on identical ones
    (case 2), each with the gradient its update read, against its
    single-process reference (rank 0), then the CLI with --dp 2 at phase 12's recipe, 2 epochs and a resume to 3, and
    3 epochs straight."""
    import contextlib
    import io

    import torch

    from hl_hgat_tpu_torch import run
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)
    model, _ = presets.zinc_pyr(seed=0)
    out = {"launches": dict.fromkeys(LAGUERRE, 0)}

    def driven(fn):
        """fn() on the main path, untimed: its launches added to the rank's."""
        with counting() as counters:
            res = fn()
            torch.cuda.synchronize()
        counts = launched(counters)
        for name, n in counts.items():
            out["launches"][name] += n
        return res, counts

    on_card = [h.to("cuda") for h in halves]
    for case, mine in (("distinct", on_card[rank]), ("identical", on_card[0])):
        trainer = DataParallelTrainer(copy.deepcopy(model), cfg)
        grads = capture_grads(trainer)
        loss, counts = driven(lambda: float(trainer.train_step(mine)))
        out[case] = dict(loss=loss, counts=counts, state=_host_state(trainer.model),
                         grads=grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(mine)
        torch.cuda.synchronize()
        out[case]["ms"] = (time.perf_counter() - t0) * 1e3 / 3
        if rank == 0:  # the single-process references, not on the main path
            if case == "distinct":
                (out[case]["ref"], out[case]["ref_loss"],
                 out[case]["ref_grads"]) = _mean_step(torch, cfg, model, on_card)
            else:
                single = Trainer(copy.deepcopy(model), cfg)
                out[case]["ref_grads"] = capture_grads(single)
                out[case]["ref_loss"] = float(single.train_step(on_card[0]))
                out[case]["ref"] = _host_state(single.model)
    del on_card
    for name, argv in (("two", DP_CLI + ["--epochs", "2", "--save_dir", save_dir]),
                       ("resume", DP_CLI + ["--epochs", "3", "--resume", "1",
                                            "--save_dir", save_dir]),
                       ("straight", DP_CLI + ["--epochs", "3",
                                              "--save_dir", save_dir + "_straight"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, counts = driven(lambda: run.main(argv))
        out[name] = dict(history=res[0]["history"], counts=counts, text=buf.getvalue(),
                         seconds=time.perf_counter() - t0)
    return out


def gp_sample(np, levels, pools, series):
    """examples/gp_brain.py's sample on the Shen-268 skeleton: level 0 and
    its MLGC level, 8 series columns a node, |FC| an edge."""
    from hl_hgat_tpu_torch.complex.build import GraphSample

    st = levels[0]
    fc = np.corrcoef(series[0])
    return GraphSample(x_t=series[0][:, :8].astype(np.float32).copy(),
                       x_s=np.abs(fc[st.src, st.dst])[:, None].astype(np.float32),
                       y=np.asarray([0.37], np.float32), levels=[levels[0], levels[1]],
                       pools=[pools[0]])


def gp_model(torch, mlp=GP_MLP):
    from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph

    return HLHGCNNGraph(BackboneConfig(**GP_MODEL), 8, 1, mlp_channels=mlp, num_classes=1,
                        generator=torch.Generator().manual_seed(0))


@contextlib.contextmanager
def activation_branches(torch, force=None):
    """Within: every ``torch.relu`` and ``F.leaky_relu`` call appends its
    input to the yielded list (float32 host arrays, in call order).  With
    ``force`` (one boolean array a call, in the same order) each call takes
    the positive branch where ``force`` is true and the other one where it
    is false, whatever its input's sign: the same outputs up to the inputs
    that change sign, and the gradient of the run that ``force`` came from."""
    import torch.nn.functional as F

    relu, leaky = torch.relu, F.leaky_relu
    seen = []

    def branch(x, slope):
        seen.append(x.detach().float().cpu().numpy())
        if force is None:
            return relu(x) if slope == 0.0 else leaky(x, slope)
        if force[len(seen) - 1].shape != tuple(x.shape):
            fail(f"[gp] activation {len(seen) - 1}: forced {force[len(seen) - 1].shape}, "
                 f"input {tuple(x.shape)}")
        return torch.where(torch.from_numpy(force[len(seen) - 1]).to(x.device), x, x * slope)

    torch.relu = lambda x: branch(x, 0.0)
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: branch(x, negative_slope)
    try:
        yield seen
    finally:
        torch.relu, F.leaky_relu = relu, leaky


def global_rows(np, parts, rows: int):
    """A graph-parallel activation in the single process's row order: the
    ranks' row blocks stacked, the tail padding cut; a replicated one (as
    many rows on a rank as in the single process) as rank 0 holds it."""
    if parts[0].shape[0] == rows:
        return parts[0]
    return np.concatenate(parts)[:rows]


def gp_rank(rank: int, world: int, sample, state, probe_state) -> dict:
    """One of two gloo ranks on the shared card: its part of the Shen-268
    complex, the eval forward and GP_STEPS ``DataParallelTrainer`` steps
    over a (1, 2) mesh, the first checked with the gradient its update
    read; then one step of the linear-head model (``probe_state``) for its
    gradient and the input of each of its activations."""
    import torch

    from hl_hgat_tpu_torch.parallel import graph_parallel as gp
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.parallel.gp_model import build_gp_batch, gp_apply
    from hl_hgat_tpu_torch.parallel.mesh import make_mesh
    from hl_hgat_tpu_torch.train import TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    batch = build_gp_batch(sample, world)
    build_s = time.perf_counter() - t0
    model = gp_model(torch).cuda()
    model.load_state_dict(state)
    with torch.inference_mode():
        out = gp_apply(model.eval(), batch).float().cpu().numpy()
    mesh = make_mesh(1, world)
    trainer = DataParallelTrainer(model, TrainerConfig(task="regression", lr=GP_LR), mesh)
    grads = capture_grads(trainer)
    loss = float(trainer.train_step(batch))
    after = _host_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GP_STEPS):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / GP_STEPS
    probe = gp_model(torch, GP_PROBE_MLP).cuda()
    probe.load_state_dict(probe_state)
    probe_trainer = DataParallelTrainer(probe, TrainerConfig(task="regression", lr=GP_LR), mesh)
    probe_grads = capture_grads(probe_trainer)
    with activation_branches(torch) as probe_acts:
        probe_loss = float(probe_trainer.train_step(batch))
    l1 = batch.level0.l1
    return dict(out=out, loss=loss, state=after, grads=grads, probe_loss=probe_loss,
                probe_grads=probe_grads, probe_acts=probe_acts, build_s=build_s, ms=ms,
                bytes=gp.exchange_bytes(l1, GP_MODEL["filters"][0]),
                rounds=l1.rounds(), halo=l1.halo_per_round, rows=l1.c_local)


def parallel_phase(torch, np, card, samples):
    """Phase 13: the parallel package on the card.  Data parallelism at
    world 1 on NCCL in this process, then at world 2 on gloo with both
    ranks on the card (distinct and identical halves of the 384 graphs,
    the --dp 2 CLI with a resume), then the graph-parallel model over two
    gloo ranks on the Shen-268 skeleton.  Returns the Laguerre launches of
    its main-path runs, the ranks' summed."""
    import tempfile

    import torch.distributed as dist

    from hl_hgat_tpu_torch.complex.build import collate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.parallel import distributed as pdist
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    label = f"on one card, ranks sharing it [{card}]"
    none = dict.fromkeys(LAGUERRE, 0)
    per_step = {**none, "laguerre_dense_fused": 18, "laguerre_dense_fused_bwd": 18}
    total = dict(none)
    cfg = TrainerConfig(task="regression", lr=1e-3, weight_decay=1e-3)

    # a. world 1 on NCCL, in this process: the DP step against Trainer.train_step
    pdist.init_distributed(0, 1, init_method=f"tcp://localhost:{pdist.free_port()}")
    if dist.get_backend() != "nccl":
        fail(f"world 1 on one card took {dist.get_backend()}, not nccl")
    batch = collate_dense_packed(samples).to("cuda")
    try:
        for dtype in ("float32", "bfloat16"):
            model, _ = presets.zinc_pyr(compute_dtype=dtype, seed=0)
            single, dp = Trainer(copy.deepcopy(model), cfg), DataParallelTrainer(model, cfg)
            dp_grads, ref_grads = capture_grads(dp), capture_grads(single)
            with counting() as counters:
                loss = float(dp.train_step(batch))
                torch.cuda.synchronize()
            counts = launched(counters)
            if counts != per_step:
                fail(f"[dp] world 1 {dtype} step launched {counts}, expected {per_step}")
            for name in total:
                total[name] += counts[name]
            ref_loss = float(single.train_step(batch))
            got, ref = _host_state(dp.model), _host_state(single.model)
            equal = all(np.array_equal(got[k], ref[k]) for k in ref)
            g_equal = all(np.array_equal(dp_grads[k], ref_grads[k]) for k in ref_grads)
            worst, where = state_error(got, ref, zero_grad_leaves(ref_grads))
            ms = {}
            for tag, tr in (("dp", dp), ("single", single)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    tr.train_step(batch)
                torch.cuda.synchronize()
                ms[tag] = (time.perf_counter() - t0) * 1e3 / 3
            print(f"[dp] world 1 nccl {dtype}, zinc_pyr on {BATCH_GRAPHS} graphs: loss "
                  f"{loss:.7f} vs Trainer.train_step {ref_loss:.7f}; parameters worst leaf "
                  f"{worst:.3e} of max|ref| ({where}), bit-equal: {'yes' if equal else 'no'} "
                  f"(gradients: {'yes' if g_equal else 'no'}); "
                  f"18 + 18 fused launches; step {ms['dp']:.3f} ms vs {ms['single']:.3f} ms "
                  f"single-process {label}", flush=True)
            if not (worst <= TOL[dtype] and abs(loss - ref_loss) <= TOL[dtype] * abs(ref_loss)):
                fail(f"[dp] world 1 {dtype} step disagrees with Trainer.train_step")
            compare_train_grads(
                f"world 1 nccl {dtype}, the gradient the update read vs Trainer.train_step's",
                dtype, *({k: torch.from_numpy(v) for k, v in g.items()}
                         for g in (dp_grads, ref_grads)),
                zero_grad_leaves(ref_grads), prefix="dp")
    finally:
        dist.destroy_process_group()

    # b. world 2 on gloo, both ranks on the card; the CLI with --dp 2
    half = len(samples) // 2
    halves = [collate_dense_packed(samples[:half]), collate_dense_packed(samples[half:])]
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        per_rank = pdist.spawn_ranks(dp_rank, 2, halves, save_dir, timeout=PARALLEL_PHASE_S)
        spawn_s = time.perf_counter() - t0
    r0 = per_rank[0]
    ref_name = {"distinct": "one Adam step on the mean gradient and mean BN statistics",
                "identical": "Trainer.train_step"}
    ref_grad_name = {"distinct": "the mean of the halves' gradients in one process",
                     "identical": "Trainer.train_step's"}
    for case in ("distinct", "identical"):
        for r in per_rank:
            if r[case]["counts"] != per_step:
                fail(f"[dp] world 2 {case} step launched {r[case]['counts']} on a rank")
        equal = all(np.array_equal(per_rank[1][case]["state"][k], v)
                    for k, v in r0[case]["state"].items())
        zero_grad = zero_grad_leaves(r0[case]["ref_grads"])
        worst, where = state_error(r0[case]["state"], r0[case]["ref"], zero_grad)
        ref_loss = r0[case]["ref_loss"]
        print(f"[dp] world 2 gloo, {case} halves of {half} graphs: loss {r0[case]['loss']:.7f} "
              f"vs {ref_loss:.7f} single-process ({ref_name[case]}); "
              f"parameters equal across ranks: {'yes' if equal else 'no'}; worst leaf "
              f"{worst:.3e} of max|ref| ({where}); 18 + 18 fused launches a step per rank; "
              f"step {r0[case]['ms']:.3f} ms {label}", flush=True)
        if not equal:
            fail(f"[dp] world 2 {case}: the ranks' parameters differ")
        if not (worst <= TRAIN_LEAF_TOL and abs(r0[case]["loss"] - ref_loss)
                <= TRAIN_NORM_TOL * abs(ref_loss)):
            fail(f"[dp] world 2 {case} step disagrees with the single-process step")
        ref_grads = {k: torch.from_numpy(v) for k, v in r0[case]["ref_grads"].items()}
        for rank, r in enumerate(per_rank):
            compare_grads(f"world 2 gloo, {case} halves, rank {rank}: the averaged gradient the "
                          f"update read vs {ref_grad_name[case]}",
                          {k: torch.from_numpy(v) for k, v in r[case]["grads"].items()},
                          ref_grads, zero_grad, TRAIN_LEAF_TOL, TRAIN_NORM_TOL, prefix="dp")
    hist = r0["two"]["history"] + r0["resume"]["history"]
    for line in (r0["two"]["text"] + r0["resume"]["text"]).splitlines():
        print(f"[dp]   {line}", flush=True)
    losses = [h["train_loss"] for h in hist]
    val = [h["val_loss"] for h in hist]
    h_str = r0["straight"]["history"][-1]
    errs = {k: abs(hist[-1][k] - h_str[k]) / abs(h_str[k]) for k in ("train_loss", "val_loss")}
    if ([h["epoch"] for h in hist] != [1, 2, 3] or not np.all(np.isfinite(losses + val))
            or "resumed from epoch 2" not in r0["resume"]["text"]):
        fail(f"[dp] the --dp 2 CLI run: epochs {[h['epoch'] for h in hist]}, losses {losses}")
    if max(errs.values()) > RESUME_RTOL:
        fail(f"[dp] --dp 2: the resumed epoch 3 is off the straight run's by {errs}")
    batches = -(-(512 - 512 // 10) // 128)  # train batches an epoch, as in phase 12
    steps = -(-batches // 2)  # grouped by the 2 ranks
    for r, rank in zip(per_rank, (0, 1)):
        for name, epochs in (("two", 2), ("resume", 1), ("straight", 3)):
            want = {**none, "laguerre_dense_fused": 18 * (steps + (rank == 0)) * epochs,
                    "laguerre_dense_fused_bwd": 18 * steps * epochs}
            if r[name]["counts"] != want:
                fail(f"[dp] --dp 2 rank {rank} {name} launched {r[name]['counts']}, "
                     f"expected {want}")
        for name, n in r["launches"].items():
            total[name] += n
    print(f"[dp] --dp 2 CLI, {steps} steps an epoch per rank at batch 128 a rank: train loss "
          f"by epoch {[round(x, 5) for x in losses]}, val {[round(x, 5) for x in val]} (the "
          f"synthetic targets are N(0, 1) draws: the L1 loss starts at its floor, E|y| = "
          f"0.798); epoch 3 resumed vs straight rel {errs['train_loss']:.2e} train, "
          f"{errs['val_loss']:.2e} val; 2 epochs {r0['two']['seconds']:.2f} s, --resume to 3 "
          f"{r0['resume']['seconds']:.2f} s, 3 straight {r0['straight']['seconds']:.2f} s; "
          f"both ranks spawned, checked and joined in {spawn_s:.1f} s {label}", flush=True)

    # c. the graph-parallel model over two gloo ranks on the Shen-268 skeleton
    levels, pools, series, _, _ = brain_data(np, with_flat=False)
    sample = gp_sample(np, levels, pools, series)
    model = gp_model(torch).cuda()
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    flat = collate([sample], multiple=1).to("cuda")
    with torch.inference_mode():
        ref_out = model.eval()(flat).float().cpu().numpy()
    single = Trainer(model, TrainerConfig(task="regression", lr=GP_LR))
    ref_grads = capture_grads(single)
    ref_loss = float(single.train_step(flat))
    ref_state = _host_state(single.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GP_STEPS):
        single.train_step(flat)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / GP_STEPS
    probe = gp_model(torch, GP_PROBE_MLP).cuda()
    probe_state = {k: v.detach().cpu().clone() for k, v in probe.state_dict().items()}
    probe_single = Trainer(probe, TrainerConfig(task="regression", lr=GP_LR))
    probe_ref = capture_grads(probe_single)
    with activation_branches(torch) as probe_acts:
        probe_ref_loss = float(probe_single.train_step(flat))
    per_rank = pdist.spawn_ranks(gp_rank, 2, sample, state, probe_state,
                                 timeout=PARALLEL_PHASE_S)
    g0 = per_rank[0]
    scale = float(np.abs(ref_out).max())
    err = max(float(np.abs(r["out"] - ref_out).max()) for r in per_rank)
    bad = [k for k, v in ref_state.items()
           if not np.allclose(g0["state"][k], v, rtol=1e-3, atol=1e-5)]
    worst, where = state_error(g0["state"], ref_state, zero_grad_leaves(ref_grads))
    halo, gather = g0["bytes"]
    print(f"[gp] Shen-268 skeleton ({levels[0].num_nodes} nodes, {levels[0].num_edges} edges, "
          f"MLGC level {levels[1].num_nodes}/{levels[1].num_edges}) over 2 gloo ranks, "
          f"gp_brain model: forward max|err| {err:.3e} (max|ref| {scale:.3e}) vs the "
          f"single-process forward; one Adam step loss {g0['loss']:.7f} vs {ref_loss:.7f}, "
          f"parameters worst leaf {worst:.3e} of max|ref| ({where}), outside rtol 1e-3 / "
          f"atol 1e-5: {bad}", flush=True)
    print(f"[gp] L1 mat-vec at {GP_MODEL['filters'][0]} columns: halo {halo} B over rounds "
          f"{g0['rounds']} ({g0['halo']} rows a block of {g0['rows']}) vs all-gather "
          f"{gather} B; host build of a part {g0['build_s']:.2f} s; step {g0['ms']:.3f} ms "
          f"graph-parallel vs {single_ms:.3f} ms single-process (mean of {GP_STEPS}) {label}",
          flush=True)
    grad_bad = {}
    # the linear-head model's activations: the graph-parallel inputs in the
    # single process's row order, held to its inputs; then the single-process
    # step again, taking the graph-parallel step's branches
    if len(probe_acts) != len(g0["probe_acts"]) or not probe_acts:
        fail(f"[gp] linear-head model: {len(probe_acts)} activations in the single process, "
             f"{len(g0['probe_acts'])} in the graph-parallel step")
    gp_acts = [global_rows(np, [r["probe_acts"][i] for r in per_rank], a.shape[0])
               for i, a in enumerate(probe_acts)]
    act_err, flips = 0.0, []
    for i, (a, b) in enumerate(zip(probe_acts, gp_acts)):
        act_err = max(act_err, float(np.abs(b - a).max()) / float(np.abs(a).max()))
        for idx in zip(*np.nonzero((a > 0) != (b > 0))):
            flips.append((i, tuple(map(int, idx)), float(a[idx]), float(b[idx])))
    probe_matched = Trainer(gp_model(torch, GP_PROBE_MLP).cuda(),
                            TrainerConfig(task="regression", lr=GP_LR))
    probe_matched.model.load_state_dict(probe_state)
    matched_ref = capture_grads(probe_matched)
    with activation_branches(torch, force=[b > 0 for b in gp_acts]):
        matched_loss = float(probe_matched.train_step(flat))
    print(f"[gp] linear-head model: {len(probe_acts)} activation calls, graph-parallel inputs "
          f"vs single-process max|err| {act_err:.3e} of the call's max|ref|; {len(flips)} "
          f"change branch (call, index, single-process, graph-parallel): {flips[:8]}; "
          f"the single-process step on the graph-parallel branches: loss {matched_loss:.7f}",
          flush=True)
    if not act_err <= TOL["float32"]:
        fail("[gp] the graph-parallel pre-activations disagree with the single-process ones")
    for tag, key, ref_g in (("gp_brain model", "grads", ref_grads),
                            ("linear-head model", "probe_grads", probe_ref),
                            ("linear-head model on the graph-parallel branches", "probe_grads",
                             matched_ref)):
        carrying = len(ref_g) - len(zero_grad_leaves(ref_g))
        compare_grads(f"{tag}, the averaged gradient the update read vs the single-process "
                      f"step's ({carrying} of {len(ref_g)} leaves carry a gradient)",
                      {k: torch.from_numpy(v) for k, v in g0[key].items()},
                      {k: torch.from_numpy(v) for k, v in ref_g.items()},
                      zero_grad_leaves(ref_g), prefix="gp")
        grad_bad[tag] = [k for k, v in ref_g.items()
                         if not np.allclose(g0[key][k], v, rtol=GP_GRAD_RTOL, atol=GP_GRAD_ATOL)]
        if any(not np.array_equal(per_rank[1][key][k], v) for k, v in g0[key].items()):
            fail(f"[gp] {tag}: the ranks' averaged gradients differ")
    print(f"[gp] gradient leaves outside rtol {GP_GRAD_RTOL} / atol {GP_GRAD_ATOL}: {grad_bad} "
          f"(the linear-head model's on its own branches reported); linear-head loss "
          f"{g0['probe_loss']:.7f} vs {probe_ref_loss:.7f}", flush=True)
    if grad_bad["gp_brain model"] or grad_bad["linear-head model on the graph-parallel branches"]:
        fail("[gp] the graph-parallel gradient disagrees with the single-process gradient")
    if abs(g0["probe_loss"] - probe_ref_loss) > 1e-4 * abs(probe_ref_loss):
        fail("[gp] the linear-head model's loss disagrees with the single-process loss")
    if not err <= TOL["float32"] * scale:
        fail("[gp] the graph-parallel forward disagrees with the single-process forward")
    if abs(g0["loss"] - ref_loss) > 1e-4 * abs(ref_loss) or bad:
        fail("[gp] the graph-parallel step disagrees with the single-process step")
    if any(not np.array_equal(per_rank[1]["state"][k], v) for k, v in g0["state"].items()):
        fail("[gp] the ranks' parameters differ")
    took = time.perf_counter() - t_phase
    print(f"[dp] phase 13 took {took:.1f} s, Laguerre launches on its main path (the ranks' "
          f"summed; the graph path launches none) {total} {label}", flush=True)
    if took > PARALLEL_PHASE_S:
        fail(f"phase 13 took {took:.1f} s, over {PARALLEL_PHASE_S} s")
    return total


def matcher_ms(np, levels, weight):
    """Host ms of the native matcher and of the pure-Python walk on the
    demo's two coarsening steps (level 0 weighted, level 1 unweighted on its
    row-major sorted list, as ``complex.coarsen.mlgc`` feeds them), and
    whether their assignments agree."""
    from hl_hgat_tpu_torch import native
    from hl_hgat_tpu_torch.complex.coarsen import graclus_cluster

    out = []
    for lvl, w in ((levels[0], weight), (levels[1], None)):
        src, dst, n = lvl.src, lvl.dst, lvl.num_nodes
        if w is None:
            order = np.lexsort((dst, src))
            src, dst = src[order], dst[order]
        t0 = time.perf_counter()
        fast = native.graclus_match(src, dst, w, n)
        t1 = time.perf_counter()
        if w is None:  # the walk over the symmetric row-major list
            ss, dd = np.concatenate([src, dst]), np.concatenate([dst, src])
            order = np.lexsort((dd, ss))
            slow = graclus_cluster(ss[order], dd[order], None, n, directed=True)
        else:
            slow = graclus_cluster(src, dst, w, n)
        t2 = time.perf_counter()
        out.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, bool(np.array_equal(fast, slow))))
    return out


def trace_kernel_names(path: str) -> set:
    """Names of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def analysis_phase(torch, np, lg, card):
    """Phase 14: the analysis layer and the examples on the card.  The brain
    demo (``examples.brain_demo``) at ANALYSIS_DEMO on the terms-kernel route
    and on the plain route from the same weights (sizes, matcher ms, per-epoch
    losses, StepTimer step ms, launches of kernels 2 and 4 per step with the
    band ones, the routes held to each other); ``trace_context`` around three
    demo steps (the trace names the terms kernels); ``enable_nan_checks`` on
    the card; the three figures' arrays on the card against the CPU;
    ``examples.gp_brain`` over two gloo ranks.  Returns the Laguerre launches
    of the kernel route's demo run."""
    import dataclasses as dc
    import tempfile

    from hl_hgat_tpu_torch.examples import brain_demo, figures, gp_brain
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.train.losses import mse_loss
    from hl_hgat_tpu_torch.utils import profiling

    def log(msg):
        print(f"[analysis] {msg}", flush=True)

    t_phase = time.perf_counter()
    lg.BAND_SHAPES.clear()
    args = brain_demo.build_argparser().parse_args(ANALYSIS_DEMO)
    t0 = time.perf_counter()
    init = brain_demo.init_stage(args, log=lambda m: log(m.strip()))
    init_s = time.perf_counter() - t0
    sizes = [(lvl.num_nodes, lvl.num_edges) for lvl in init.levels]
    weight = np.abs(np.mean([smp.x_s[:, 0] for smp in init.train + init.val], axis=0))
    matcher = matcher_ms(np, init.levels, weight)
    log(f"init at {init.rois} ROIs, {args.subjects} subjects, T = {args.t}: pyramid (nodes, "
        f"edges) {sizes}, {init_s:.2f} s host; matcher ms native vs pure Python (same "
        "assignments): " + "; ".join(f"level {i} {a:.3f} vs {b:.3f} ({'yes' if same else 'no'})"
                                     for i, (a, b, same) in enumerate(matcher)))
    if init.rois != 268 or len(init.levels) != 3:
        fail(f"[analysis] the demo built {init.rois} ROIs and {len(init.levels)} levels")
    t0 = time.perf_counter()
    train = brain_demo.batches(init.train, args.batch_size, "cuda")
    val = brain_demo.batches(init.val, args.batch_size, "cuda")
    torch.cuda.synchronize()
    log(f"{len(train)} train batches and {len(val)} val batch(es) of shared operators (L1 "
        f"{[tuple(lvl.l1.shape) for lvl in train[0].levels]}) collated and moved in "
        f"{time.perf_counter() - t0:.2f} s")
    # the band operators (padded rows, float32's TF32 halves) are prepared
    # at a batch's first band launch and read from the cache after it
    l1 = train[0].levels[0].l1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = lg.band_operator(l1, torch.float32)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    hit_ms = median_ms(torch, lambda: lg.band_operator(l1, torch.float32), 5)
    log(f"the level-0 L1 ({l1.shape[-1]} rows) as the band kernels read it, rows padded to "
        f"{op.ld}, TF32 halves: prepared once for the batch in {prep_ms:.4f} ms host "
        f"(synchronized); every later band launch pays the cache lookup, {hit_ms:.4f} ms "
        f"[{card}]")
    band_ops = {id(t) for b in train for lvl in b.levels for t in (lvl.l0, lvl.l1)
                if t.shape[-1] > lg.RESIDENT_ROWS}
    model, meta = brain_demo.build_model(init, "cuda")
    state = copy.deepcopy(model.state_dict())
    steps = len(train) * args.epochs

    results, main_path = {}, {}
    for route, (fused, terms) in ANALYSIS_ROUTES.items():
        conv.use_fused_dense(fused)
        conv.use_terms_kernel(terms)
        # the counted run (its first launches prepare the band operators),
        # then one epoch timed on a copy from the same weights
        model.load_state_dict(state)
        timed = copy.deepcopy(model)
        with counting() as counters:
            losses = brain_demo.train_stage(model, train, args.epochs, log=lambda m: None)
        counts = launched(counters)
        timer = profiling.StepTimer()
        brain_demo.train_stage(timed, train, 1, log=lambda m: None, timer=timer)
        del timed
        band, prepared = (counters.get(k, 0) for k in ("band_launches", "prepared.band_operator"))
        with counting() as counters:
            ev = brain_demo.evaluate_stage(model, val, meta, log=lambda m: None)
        eval_counts = launched(counters)
        an = brain_demo.analyze_stage(dc.replace(init, rng=copy.deepcopy(init.rng)),
                                      ev["edge_att"], log=lambda m: None)
        if route == "terms":
            main_path = {k: counts[k] + eval_counts[k] for k in counts}
        results[route] = dict(losses=losses, ev=ev, an=an)
        ms = [t * 1e3 for t in timer.times]
        per = {k: counts[k] / steps for k in ("laguerre_terms_dense", "laguerre_terms_dense_bwd")}
        log(f"{route} route: epoch losses {[round(x, 6) for x in losses]}; step ms (StepTimer, "
            f"synchronized, an epoch on a copy after the counted run) first {ms[0]:.1f}, "
            f"median of the rest {statistics.median(ms[1:]):.3f}; launches a step (kernels "
            f"2, 4) {per['laguerre_terms_dense']:g} + {per['laguerre_terms_dense_bwd']:g}, band "
            f"{band / steps:g}, fused {counts['laguerre_dense_fused']}; val forward "
            f"{eval_counts}; corr {ev['corr']:.3f}, RMSE {ev['rmse']:.3f} [{card}]")
        if not np.isfinite(losses).all() or not np.isfinite(ev["pred"]).all():
            fail(f"[analysis] {route} route: non-finite losses or predictions")
        if route == "terms":
            # the level-0 L1 above is already prepared; every other band
            # operator of the train batches at most once, whatever the steps
            log(f"terms route: {band} band launches over {steps} steps prepared "
                f"{prepared} band operators (the train batches hold {len(band_ops)} over "
                f"{lg.RESIDENT_ROWS} rows, the level-0 L1 of the first prepared before): no "
                f"band launch after a batch's first copies or casts its operators")
            if prepared > len(band_ops) - 1:
                fail(f"[analysis] {prepared} band operator preparations for {len(band_ops)} "
                     "operators, one already prepared: a band launch prepared one again")
            if min(per.values()) <= 0 or band <= 0:
                fail(f"[analysis] the kernel route launched {counts} (band {band})")
            if counts["laguerre_dense_fused"] or counts["laguerre_dense_fused_bwd"]:
                fail(f"[analysis] the shared layout took the fused kernel: {counts}")
        elif any(counts.values()) or any(eval_counts.values()) or band:
            fail(f"[analysis] the plain route launched {counts} {eval_counts}")
    # the kernel route's trained weights served on the plain route
    conv.use_fused_dense(False)
    conv.use_terms_kernel(False)
    ev = brain_demo.evaluate_stage(model, val, meta, log=lambda m: None)
    served = dict(ev=ev, an=brain_demo.analyze_stage(
        dc.replace(init, rng=copy.deepcopy(init.rng)), ev["edge_att"], log=lambda m: None))
    # the kernel route's steps again from the same weights; before each, both
    # routes' loss and gradient on its weights and batch
    model.load_state_dict(state)
    optimizer = brain_demo.adam_l2(model.parameters(), lr=brain_demo.LR)
    loss_err = []
    for step in range(steps):
        batch = train[step % len(train)]
        seen = {}
        for route in ("plain", "terms"):  # the step reads the kernel route's gradient
            conv.use_terms_kernel(ANALYSIS_ROUTES[route][1])
            model.train().zero_grad(set_to_none=True)
            loss = mse_loss(model(batch)[0].reshape(-1), batch.y.reshape(-1))
            loss.backward()
            seen[route] = (float(loss.detach()), {n: p.grad.detach().clone()
                                                  for n, p in model.named_parameters()})
        optimizer.step()
        (loss, grads), (ref_loss, ref_grads) = seen["terms"], seen["plain"]
        loss_err.append(abs(loss - ref_loss) / abs(ref_loss))
        if step == 0:  # the biases a BatchNorm on batch statistics follows, at any weights
            zero_grad = zero_grad_leaves(ref_grads)
        compare_train_grads(f"brain demo terms vs plain route on the kernel route's step {step}",
                            "float32", grads, ref_grads, zero_grad, prefix="analysis")
    log(f"the kernel route's {steps} steps: both routes' loss on its weights, worst rel "
        f"{max(loss_err):.3e} (step 0: {loss_err[0]:.3e}); leaves whose gradient is rounding "
        f"at the shared weights, held to the largest entry: {sorted(zero_grad)}")
    if not max(loss_err) <= TOL["float32"]:
        fail("[analysis] the kernel route's loss disagrees with the plain route's")
    # runs trained apart, beside the plain route run again from the same weights
    apart = {}
    for name, make in (("Adam", lambda p: brain_demo.adam_l2(p, lr=brain_demo.LR)),
                       (f"SGD at lr {ANALYSIS_SGD_LR:g}",
                        lambda p: torch.optim.SGD(p, lr=ANALYSIS_SGD_LR))):
        runs = {"terms": results["terms"]["losses"], "plain": results["plain"]["losses"]}
        for route in (("plain again",) if name == "Adam" else ("terms", "plain", "plain again")):
            conv.use_terms_kernel(route == "terms")
            model.load_state_dict(state)
            optimizer = make(model.parameters())
            runs[route] = [float(torch.stack([brain_demo.train_step(model, optimizer, b)
                                             for b in train]).mean())
                           for _ in range(args.epochs)]
        apart[name] = runs
    conv.use_fused_dense(True)
    conv.use_terms_kernel(False)
    for name, runs in apart.items():
        rel = {k: max(abs(a - b) / abs(b) for a, b in zip(runs[k], runs["plain"]))
               for k in ("terms", "plain again")}
        log(f"{name}, {steps} steps trained apart from the same weights (reported): epoch losses "
            + "; ".join(f"{k} {[round(x, 6) for x in v]}" for k, v in runs.items())
            + f"; worst rel to the plain run: terms {rel['terms']:.3e}, plain again "
              f"{rel['plain again']:.3e}")
    got = results["terms"]
    errs = {}
    for tag, ref in (("same weights", served), ("trained apart", results["plain"])):
        pred_scale = float(np.abs(ref["ev"]["pred"]).max())
        att_scale = float(np.abs(ref["an"]["fc_att"]).max())
        errs[tag] = (float(np.abs(got["ev"]["pred"] - ref["ev"]["pred"]).max()) / pred_scale,
                     float(np.abs(got["an"]["fc_att"] - ref["an"]["fc_att"]).max()) / att_scale)
    log(f"kernel route vs plain route: validation predictions and attention matrix, "
        f"max|err| / max|ref|: the kernel route's weights on both routes "
        f"{errs['same weights'][0]:.3e}, {errs['same weights'][1]:.3e}; the two "
        f"routes trained apart {errs['trained apart'][0]:.3e}, {errs['trained apart'][1]:.3e} "
        f"(reported); top edges {tuple(map(int, got['an']['top']))} / "
        f"{tuple(map(int, results['plain']['an']['top']))}")
    for route, res in results.items():
        if not res["losses"][-1] < res["losses"][0]:
            fail(f"[analysis] {route} route: the epoch loss did not fall {res['losses']}")
    if not max(errs["same weights"]) <= ANALYSIS_TOL:
        fail("[analysis] the kernel route's predictions or attention disagree with plain")

    # trace_context around three demo steps on the kernel route
    conv.use_terms_kernel(True)
    optimizer = brain_demo.adam_l2(model.parameters(), lr=brain_demo.LR)
    brain_demo.train_step(model, optimizer, train[0])
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        with profiling.trace_context(logdir) as prof:
            for i in range(ANALYSIS_TRACE_STEPS):
                brain_demo.train_step(model, optimizer, train[i % len(train)])
            torch.cuda.synchronize()
        trace_s = time.perf_counter() - t0
        path = f"{logdir}/{profiling.TRACE_FILE}"
        size = os.path.getsize(path)
        names = trace_kernel_names(path)
    conv.use_terms_kernel(False)
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    import re

    ours = sorted({m.group(0) for m in (re.search(r"\w*(terms_|band_)\w*", n) for n in names)
                   if m})
    log(f"trace of {ANALYSIS_TRACE_STEPS} steps: {size} B Chrome trace, {len(names)} kernel "
        f"names, {device_us / 1e3 / ANALYSIS_TRACE_STEPS:.3f} device ms a step, "
        f"{trace_s:.2f} s with the trace written; the terms kernels in it: {ours}")
    if not any("terms_" in n for n in ours) or not any("band_" in n for n in ours):
        fail("[analysis] the trace does not name the terms kernels (resident and band)")

    # enable_nan_checks on the card
    profiling.enable_nan_checks(True)
    try:
        zeros = torch.zeros(4, device="cuda")
        try:
            zeros / zeros
        except FloatingPointError as err:
            raised = str(err)
        else:
            fail("[analysis] a / a on zeros raised nothing with NaN checks on")
        conv.use_terms_kernel(True)
        with counting() as counters:
            t0 = time.perf_counter()
            with torch.no_grad():
                model.eval()(val[0])
            torch.cuda.synchronize()
            checked_s = time.perf_counter() - t0
        checked = launched(counters)["laguerre_terms_dense"]
    finally:
        profiling.enable_nan_checks(False)
        conv.use_terms_kernel(False)
    log(f"NaN checks: a / a on zeros raised ({raised}); a demo forward with checks on raised "
        f"nothing ({checked} terms launches checked after launch, {checked_s:.2f} s with the "
        f"recorder on)")
    if checked == 0:
        fail("[analysis] the checked forward launched no terms kernel")

    # the figures' arrays on the card against the CPU, the same weights
    t0 = time.perf_counter()
    errs = {}
    for name, fn in (("tsp_trend", figures.tsp_trend_arrays),
                     ("cifar_attention", figures.cifar_attention_arrays)):
        card_arrays, cpu_arrays = fn(0, "cuda"), fn(0, "cpu")
        keys = ("node", "edge") if name == "tsp_trend" else ("a_t", "a_s")
        for key in keys:
            a, b = np.asarray(card_arrays[key]), np.asarray(cpu_arrays[key])
            errs[f"{name}.{key}"] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                                     1e-30)
    brain_fc = figures.brain_fc_arrays(0)["matrix"]  # host NumPy: no device to compare
    log(f"figure arrays card vs CPU, max|err| / max|ref|: "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }; brain_fc {brain_fc.shape} on "
        f"the host ({time.perf_counter() - t0:.2f} s)")
    if max(errs.values()) > TOL["float32"]:
        fail("[analysis] a figure's arrays on the card disagree with the CPU's")

    # gp_brain over two gloo ranks sharing the card
    t0 = time.perf_counter()
    gp_results = gp_brain.main(GP_DEMO)
    gp_s = time.perf_counter() - t0
    losses = gp_results[0]["losses"]
    log(f"gp_brain {' '.join(GP_DEMO)}: losses {[round(x, 6) for x in losses]}, ranks' launches "
        f"{[r['launches'] for r in gp_results]}; {gp_s:.1f} s with spawn and join, steps "
        f"{gp_results[0]['seconds'][-1]:.2f} s (on one card, ranks sharing it) [{card}]")
    if not np.isfinite(losses).all() or losses != gp_results[1]["losses"]:
        fail("[analysis] gp_brain's losses are not finite or differ across ranks")

    print_band_shapes(torch, lg, "phase 14")
    took = time.perf_counter() - t_phase
    log(f"phase 14 took {took:.1f} s; Laguerre launches on its main path (the kernel route's "
        f"demo run) {main_path} [{card}]")
    if took > ANALYSIS_PHASE_S:
        fail(f"phase 14 took {took:.1f} s, over {ANALYSIS_PHASE_S} s")
    return main_path


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
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, then phase 13 alone (the parallel package), no result line")
    ap.add_argument("--analysis-only", action="store_true",
                    help="build, then phase 14 alone (the analysis layer and the examples), "
                         "no result line")
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
    for lib, (opcodes, wanted) in MMA_KERNELS.items():
        if lib not in cuda_build.SOURCES:  # an older tree, run for comparison
            continue
        counts = {}
        for kernel, n in cuda_build.tensor_core_opcodes(lib).items():
            # an older tree's reader counts HMMA and HGMMA together, and its
            # kernels are held to that count
            counts[kernel] = n if isinstance(n, dict) else {"HMMA or HGMMA": n}
            print(f"[build] {lib}: {kernel}: "
                  + ", ".join(f"{v} {op}" for op, v in counts[kernel].items()), flush=True)
        for name in wanted:
            for bf16 in (False, True):
                found = [sum(v for op, v in n.items() if op in opcodes or " or " in op)
                         for kernel, n in counts.items()
                         if name in kernel and ("bfloat16" in kernel) == bf16]
                if not found or min(found) == 0:
                    fail(f"{name} ({'bfloat16' if bf16 else 'float32'}) holds no "
                         f"{' or '.join(opcodes)}: {found}")
        if "HMMA" not in opcodes:  # wgmma kernels: no mma.sync left in them
            held = {kernel: n["HMMA"] for kernel, n in counts.items()
                    if any(name in kernel for name in wanted) and n.get("HMMA")}
            if held:
                fail(f"{lib}: wgmma kernels hold HMMA: {held}")

    # ---- data -------------------------------------------------------------
    t0 = time.perf_counter()
    samples = zinc_like_samples(np.random.default_rng(0), BATCH_GRAPHS)
    host_batch = collate_dense_packed(samples)
    real_edges = int(host_batch.level0.edge_mask.sum())
    g = host_batch.x_t.shape[0]
    print(f"[data] {BATCH_GRAPHS} graphs, {real_edges} real edges, {g} blocks of "
          f"{host_batch.x_t.shape[1]} ({time.perf_counter() - t0:.2f} s host)", flush=True)

    if args.parallel_only:
        parallel_phase(torch, np, card, samples)
        print("[parallel-only] done, no result line", flush=True)
        return 0
    if args.analysis_only:
        analysis_phase(torch, np, lg, card)
        print("[analysis-only] done, no result line", flush=True)
        return 0

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
            print_laguerre_summary(summary, LAGUERRE, card)
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
    launches = dict.fromkeys(LAGUERRE, 0)
    none = dict.fromkeys(LAGUERRE, 0)
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
            # the entry point a user calls: samples in, [N, 1] out
            with counting() as counters:
                outs[route] = pred(samples)
            counts = launched(counters)
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
    for name, n in zinc_wide_phase(torch, np, model32, samples, served, card).items():
        launches[name] += n

    # ---- 8. the pooled path: cifar10sp_attpool served and trained ----------
    pooled_launches, pooled_ell = pooled_phase(torch, np, pooled_model, pooled_samples,
                                               card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if pooled_launches[name] == 0:
            fail(f"{name} was never launched on the pooled path")
    for name, n in pooled_launches.items():
        launches[name] += n
    for name, n in pooled_ell.items():
        ell_launches[name] += n

    # ---- 9. the large-graph layout: TSP-500 trained, served edge by edge ---
    tsp_launches, tsp_ell = tsp_phase(torch, np, card)
    if tsp_launches["laguerre_dense_fused"] == 0 or tsp_ell["spmm_ell"] == 0:
        fail(f"the TSP phase launched {tsp_launches} {tsp_ell}")
    for name, n in tsp_launches.items():
        launches[name] += n
    for name, n in tsp_ell.items():
        ell_launches[name] += n

    # ---- 10. the brain family on the shared-skeleton layout ------------------
    brain_launches, brain_ell, brain_summary = brain_phase(torch, np, lg, card)
    for name in ("laguerre_terms_dense", "laguerre_terms_dense_bwd"):
        if brain_launches[name] == 0:
            fail(f"{name} was never launched on the brain path")
    for name, n in brain_launches.items():
        launches[name] += n
    for name, n in brain_ell.items():
        ell_launches[name] += n

    # ---- 11. the data pipeline feeding full-width zinc_pyr training ----------
    data_launches, data_ell = data_phase(torch, np, card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if data_launches[name] == 0:
            fail(f"{name} was never launched on the data pipeline's path")
    for name, n in data_launches.items():
        launches[name] += n
    for name, n in data_ell.items():
        ell_launches[name] += n

    # ---- 12. checkpoint, resume, --test and serving of the shipped weights ---
    ckpt_launches = checkpoint_phase(torch, np, card)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if ckpt_launches[name] == 0:
            fail(f"{name} was never launched on the checkpoint phase's path")
    for name, n in ckpt_launches.items():
        launches[name] += n

    # ---- 13. the parallel package: DP on NCCL and gloo, --dp 2, graph parallel ---
    dp_launches = parallel_phase(torch, np, card, samples)
    for name in ("laguerre_dense_fused", "laguerre_dense_fused_bwd"):
        if dp_launches[name] == 0:
            fail(f"{name} was never launched on the parallel phase's path")
    for name, n in dp_launches.items():
        launches[name] += n

    # ---- 14. the analysis layer, the brain demo at 268 ROIs, the examples ----
    analysis_launches = analysis_phase(torch, np, lg, card)
    for name in ("laguerre_terms_dense", "laguerre_terms_dense_bwd"):
        if analysis_launches[name] == 0:
            fail(f"{name} was never launched on the brain demo's path")
    for name, n in analysis_launches.items():
        launches[name] += n

    # ---- 15. result lines -------------------------------------------------
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
