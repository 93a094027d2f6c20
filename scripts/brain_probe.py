#!/usr/bin/env python3
"""Two measurements of the brain path on one CUDA card, beside
``chip_smoke.py``'s phase 10.

    python3 scripts/brain_probe.py [--only stride|cudnn]

``stride``: the band terms kernels (forward and backward) on the folded
level-0 L1 of the Shen-268 pyramid (S = 8997 rows, K = 4, C = 16 x each
conv's input width) through the wrappers, with the band operator (rows
padded to 16 bytes, float32's TF32 halves) from the cache and prepared
anew in every call; both must give the same bits; each is timed as
``chip_smoke.py`` times a kernel (ten calls replayed as a CUDA graph).  A
parent tree's copy of this script times that tree's kernels the same way.

``cudnn``: the float32 ``hgat_attpool`` training step at batch 16 under
four cuDNN settings, each in a process of its own (PyTorch caches a
convolution's plan by shape, not by setting): cuDNN's heuristics
(``nn.inception._CUDNN_AUTOTUNE`` cleared), its autotuner (the port's
default, ``torch.backends.cudnn.benchmark``), the heuristics with the
workspace capped at 4096 MiB (``CUDNN_CONV_WSCAP_DBG``) and cuDNN off;
then heuristics and autotuner at batch 32.  Each prints the mean of 3
steps after one warm-up step, the peak device memory over them and the
top device operations of one profiled step (their names say which
convolution algorithm ran).  A step that runs out of device memory, or a
setting that takes longer than its time limit (600 s, 120 s with cuDNN
off), is reported, not fatal.  Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CUDNN_SETTINGS = ("heuristics", "autotune", "wscap", "off")
WSCAP_MIB = 4096


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def brain_model(torch, np, batch_size: int):
    """hgat_attpool at the recipe's widths and a shared batch of
    ``batch_size`` subjects on the card."""
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import BrainPredictor

    levels, pools, series, host, _ = cs.brain_data(np, with_flat=False)
    final, fine = levels[2], levels[0]
    model, _ = presets.hgat_attpool(
        **cs.BRAIN_MODEL, nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
        fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges, seed=0)
    if batch_size == cs.BRAIN_BATCH:
        return model, host.to("cuda")
    reps = -(-batch_size // len(series))
    subjects = (list(series) * reps)[:batch_size]
    return model, BrainPredictor(model, levels, pools, batch_size=batch_size).collate(subjects)


def stride(torch, np, card):
    from hl_hgat_tpu_torch.nn import conv
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    model, batch = brain_model(torch, np, cs.BRAIN_BATCH)
    cases = [c for c in cs.brain_conv_cases(torch, conv, model, batch)
             if c[0] == 0 and c[1] == "L1"]
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        lb = batch.levels[0].l1.to(td).contiguous()
        s = lb.shape[1]
        for _, _, _, k, c, count in cases:
            rng = np.random.default_rng([3, s, k, c])
            x = torch.from_numpy(rng.standard_normal((1, s, c)).astype(np.float32)).cuda().to(td)
            dt = torch.from_numpy(rng.standard_normal((k, 1, s, c)).astype(np.float32)
                                  ).cuda().to(td)
            runs = {
                "laguerre_terms_dense": lambda: lg.laguerre_terms_dense(lb, x, k),
                "laguerre_terms_dense_bwd": lambda: lg.laguerre_terms_dense_bwd(lb, dt, k),
            }
            for name, wrapper in runs.items():

                def fresh(wrapper=wrapper):
                    lg._prepared.clear()  # the operator prepared anew, as every launch once did
                    return wrapper()

                got = [wrapper(), fresh()]
                if not torch.equal(got[0], got[1]):
                    cs.fail(f"{name} {dtype} C={c}: cached and fresh operators give other bits")
                ms = [cs.graph_ms(torch, fn, cs.KERNEL_CALLS) for fn in (wrapper, fresh)]
                op = lg.band_operator(lb, td)
                print(f"[stride] {name} {dtype} G=1 S={s} C={c} K={k} (x{count} a forward), "
                      f"L's rows padded to {op.ld}: the operator from the cache (prepared "
                      f"once a batch) {ms[0]:.4f} ms, prepared in the call {ms[1]:.4f} ms, "
                      f"ratio {ms[1] / ms[0]:.2f}; same bits [{card}]", flush=True)


def cudnn_one(torch, np, card, setting: str, batch_size: int):
    """The float32 training step under one cuDNN setting, in this process."""
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    from hl_hgat_tpu_torch.nn import inception

    # Inception1D's forward turns the autotuner on unless this is cleared
    inception._CUDNN_AUTOTUNE = setting == "autotune"
    if setting == "off":
        torch.backends.cudnn.enabled = False
    model, batch = brain_model(torch, np, batch_size)
    cfg = TrainerConfig(task="brain", lr=1e-4, weight_decay=1e-4, metric_mode="max")
    trainer = Trainer(copy.deepcopy(model), cfg)
    what = f"[cudnn] float32 step, batch {batch_size}, {setting}"
    if setting == "wscap":
        what += f" ({WSCAP_MIB} MiB)"
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 3
        peak = torch.cuda.max_memory_allocated() / 1e9
        dev, busy, top = cs.device_profile(torch, lambda: trainer.train_step(batch), 1, top=8)
    except torch.cuda.OutOfMemoryError as e:
        print(f"{what}: out of device memory ({str(e).splitlines()[0]}) [{card}]", flush=True)
        return
    print(f"{what}: step {step_ms:.3f} ms (mean of 3 after a warm-up; device {dev:.3f} ms, "
          f"busy {100 * busy:.1f}%), peak device memory {peak:.2f} GB [{card}]", flush=True)
    print(f"{what}, top device operations: " + "; ".join(
        f"{name[:70]} {ms:.3f} ms x{n:g}" for name, ms, n in top), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("stride", "cudnn"), default=None)
    ap.add_argument("--cudnn-setting", choices=CUDNN_SETTINGS, default=None,
                    help=argparse.SUPPRESS)  # one setting, in a child process
    ap.add_argument("--batch", type=int, default=cs.BRAIN_BATCH, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("brain_probe: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    from hl_hgat_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    if args.cudnn_setting:
        cudnn_one(torch, np, card, args.cudnn_setting, args.batch)
        return 0
    cuda_build.build()
    print(card, flush=True)
    if args.only in (None, "stride"):
        stride(torch, np, card)
    if args.only in (None, "cudnn"):
        runs = [(setting, cs.BRAIN_BATCH) for setting in CUDNN_SETTINGS]
        runs += [("heuristics", 2 * cs.BRAIN_BATCH), ("autotune", 2 * cs.BRAIN_BATCH)]
        for setting, bs in runs:
            env = dict(os.environ)
            if setting == "wscap":
                env["CUDNN_CONV_WSCAP_DBG"] = str(WSCAP_MIB)
            limit = 120 if setting == "off" else 600
            try:
                subprocess.run([sys.executable, __file__, "--cudnn-setting", setting,
                                "--batch", str(bs)], env=env, check=True, timeout=limit)
            except subprocess.TimeoutExpired:  # the child is killed
                print(f"[cudnn] float32 step, batch {bs}, {setting}: not done in {limit} s "
                      f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
