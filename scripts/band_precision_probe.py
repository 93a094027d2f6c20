#!/usr/bin/env python3
"""Where the float32 gradient of ``hgat_attpool`` departs from float64, on one
CUDA card.

    python3 scripts/band_precision_probe.py errors [--variants ...]
    python3 scripts/band_precision_probe.py model [--seeds ...] [--variants ...] [--perturb N]
    python3 scripts/band_precision_probe.py census [--seeds S] --variants A B
    python3 scripts/band_precision_probe.py time

``errors``: on the benchmark cell's level-0 L1 (S = 8997, the Shen-268
skeleton's, from ``portbench``'s own batch), K = 4 and 64 subjects folded
into the columns: the band terms kernels alone (forward terms, backward dx
from a seeded cotangent) at C = 64 (the edge input's one channel a subject)
and C = 2048 (32 a subject), the conv as the model runs it (folded terms,
then the stack GEMMs: dW and dx of a seeded cotangent), and the fused band
kernels at G = 1 (their products ``band_out``/``band_bar``/``band_dw``).  Each
against float64: ``rel`` = ‖y − ref‖ / ‖ref‖, ``proj`` = ⟨y − ref, ref⟩ /
‖ref‖² (a bias towards zero reads negative), ``max`` = max|y − ref| /
max|ref|.

``model``: the cell's first gradient (one ``Trainer.train_step`` on the
seed's first batch, as the benchmark takes it) against the float64
reference's, by leaf as ``portbench/compare.py`` measures it (median and
worst leaf, the worst three named), and the prediction's gap
(``pred_gap``'s measure); the reference in float32 (TF32 off) gives the
class.  ``--perturb N`` adds N trials on the first seed with its series
scaled by 1 + 1e-6·N(0, 1), both sides alike.

``census``: the two variants' forward on the first seed, and for every
ReLU and leaky ReLU input, how many elements fall on other sides of the
kink and how near to it they lie.

Variants: ``band`` (the tree as it is), ``plain`` (the band wrappers
replaced by the plain PyTorch versions on the card, TF32 off), ``emulated``
(those under ``emulated_products("tf32x3")``), ``nocudnn`` (cuDNN off, so
Inception1D runs ATen's own convolutions), ``onepass`` (MaskedBatchNorm as
the JAX module computes it: E[x²] − E[x]² and a folded apply), and their
``+`` combinations.

``time``: the band terms kernels at S = 8997, K = 4, through the wrappers
with the operator cached, ten calls replayed as a CUDA graph
(``chip_smoke.graph_ms``): C = 16 and 512 (16 subjects, the shapes of
``chip_smoke.py``'s phase 10) and C = 64, 2048 and 4096 (the cell's), with
a hash of the outputs' bits.  A parent tree's copy times that tree's
kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CELL_CONFIG = ROOT / "portbench" / "configs" / "hgat_attpool.json"
CELL_MIX = ROOT / "portbench" / "traffic" / "train_b64.json"
K = 4
DEVICE = "cuda"
VARIANTS = ("band", "plain", "emulated", "onepass", "plain+onepass")


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cell():
    from portbench import spec

    cfg = json.loads(CELL_CONFIG.read_text())
    mix = json.loads(CELL_MIX.read_text())
    adapter = spec.load_module(ROOT / "portbench" / "configs" / "hgat_attpool.py")
    return cfg, mix, adapter


def first_batch(seed: int):
    cfg, mix, adapter = cell()
    raw = adapter.draw_train(cfg, mix, seed, 4).get()[0]
    return raw, adapter.program_batch(cfg, raw).to(DEVICE)


@contextlib.contextmanager
def variant(name: str):
    """The port with the named parts replaced, within the block."""
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    saved = (lg._terms_fwd_cuda, lg.laguerre_terms_dense_bwd, lg._fused_fwd_cuda,
             lg.laguerre_dense_fused_bwd, torch.backends.cudnn.enabled)
    parts = name.split("+")
    with contextlib.ExitStack() as stack:
        if "plain" in parts or "emulated" in parts:
            lg._terms_fwd_cuda = lg.laguerre_terms_dense_plain
            lg.laguerre_terms_dense_bwd = lg.laguerre_terms_dense_bwd_plain
            lg._fused_fwd_cuda = lg.laguerre_dense_fused_plain
            lg.laguerre_dense_fused_bwd = lg.laguerre_dense_fused_bwd_plain
        if "emulated" in parts:
            stack.enter_context(lg.emulated_products("tf32x3"))
        if "nocudnn" in parts:
            torch.backends.cudnn.enabled = False
        if "onepass" in parts:
            from hl_hgat_tpu_torch.nn import norm
            stack.enter_context(_patched(norm.MaskedBatchNorm, "forward", _one_pass_forward))
        try:
            yield
        finally:
            (lg._terms_fwd_cuda, lg.laguerre_terms_dense_bwd, lg._fused_fwd_cuda,
             lg.laguerre_dense_fused_bwd, torch.backends.cudnn.enabled) = saved


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _one_pass_forward(self, x, mask=None):
    """MaskedBatchNorm as the JAX module computes it (probe variant): the
    variance as E[x²] − E[x]² in one pass, the apply folded into
    x·a + (β − mean·a)."""
    from hl_hgat_tpu_torch.nn import norm

    m = None if mask is None else mask.reshape(
        mask.shape + (1,) * (x.ndim - mask.ndim)).float()
    xf = x.float()
    if self.training:
        axes = tuple(range(x.ndim - 1))
        ones = torch.ones_like(xf[..., :1]) if m is None else m
        n = torch.clamp(ones.sum() * (xf[..., 0].numel() / max(ones.numel(), 1)), min=1.0)
        mean = (xf * ones).sum(axes) / n
        var = torch.clamp((xf * xf * ones).sum(axes) / n - mean * mean, min=0.0)
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            self.running_mean.mul_(1 - norm.MOMENTUM).add_(norm.MOMENTUM * mean)
            self.running_var.mul_(1 - norm.MOMENTUM).add_(norm.MOMENTUM * unbiased)
    else:
        mean, var = self.running_mean, self.running_var
    a = self.weight * (1.0 / torch.sqrt(var + norm.EPS))
    y = xf * a + (self.bias - mean * a)
    return (y if m is None else y * m).to(x.dtype)


def sync():
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def gap(y: torch.Tensor, ref: torch.Tensor) -> str:
    y, ref = y.detach(), ref.detach()
    d = y.double() - ref
    nr = float(ref.norm())
    return (f"rel {float(d.norm()) / nr:.3e} proj {float((d * ref).sum()) / nr ** 2:+.3e} "
            f"max {float(d.abs().max()) / float(ref.abs().max()):.3e}")


def terms64(l64: torch.Tensor, x: torch.Tensor, k: int) -> list[torch.Tensor]:
    terms = [x]
    if k > 1:
        terms.append(x - l64 @ x)
    for j in range(1, k - 1):
        terms.append((-(l64 @ terms[-1]) + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
    return terms


def seeded(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(DEVICE)


def errors(variants, card):
    from hl_hgat_tpu_torch.nn.conv import laguerre_matvec
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    _, batch = first_batch(2147483705)
    lap = batch.levels[0].l1.float().contiguous()  # [1, S, S]
    s = lap.shape[-1]
    l64 = lap.double()
    x_edge = batch.x_s.float()  # [64, S, 1]: the FC value of each edge
    g_sub = x_edge.shape[0]
    cases = [("C=64 (edge input)", x_edge.movedim(0, 1).reshape(1, s, g_sub), 1),
             (f"C={32 * g_sub}", seeded((1, s, 32 * g_sub), 11), 32)]
    for what, folded, c_in in cases:
        c = folded.shape[-1]
        x64 = folded.double()
        ref_t = terms64(l64, x64, K)
        dt = seeded((K, 1, s, c), 12)
        xr = x64.clone().requires_grad_(True)
        ref_dx = torch.autograd.grad(
            sum((t * d.double()).sum() for t, d in zip(terms64(l64, xr, K), dt)), xr)[0]
        # the conv as the model runs it: x [G, S, C_in] on the shared L
        x3 = folded.reshape(s, g_sub, c_in).movedim(1, 0).contiguous()
        w = seeded((K, c_in, 32), 13, 1.0 / np.sqrt(c_in))
        b = torch.zeros(32, device=DEVICE)
        gout = seeded((g_sub, s, 32), 14)
        xr3 = x3.double().requires_grad_(True)
        wr = w.double().requires_grad_(True)
        t3 = terms64(l64, xr3, K)
        out64 = sum(t @ wr[kk] for kk, t in enumerate(t3))
        ref_cdx, ref_cdw = torch.autograd.grad((out64 * gout.double()).sum(), (xr3, wr))
        for name in variants:
            with variant(name):
                t = lg.laguerre_terms_dense(lap, folded, K)
                dx = lg.laguerre_terms_dense_bwd(lap, dt, K)
                xv = x3.clone().requires_grad_(True)
                wv = w.clone().requires_grad_(True)
                out = laguerre_matvec(xv, lap, wv, b)
                cdx, cdw = torch.autograd.grad((out * gout).sum(), (xv, wv))
                sync()
            for kk in range(1, K):
                print(f"[errors] {what} {name}: terms T{kk} {gap(t[kk], ref_t[kk])}", flush=True)
            print(f"[errors] {what} {name}: terms bwd dx {gap(dx, ref_dx)}", flush=True)
            print(f"[errors] {what} {name}: conv out {gap(out, out64.detach())}; "
                  f"dW {gap(cdw, ref_cdw)}; dx {gap(cdx, ref_cdx)} [{card}]", flush=True)
    # the fused band kernels at G = 1 (products on wgmma): C = 64, F = 32
    x = seeded((1, s, 64), 15)
    w = seeded((K, 64, 32), 16, 0.125)
    b = seeded((32,), 17)
    g = seeded((1, s, 32), 18)
    x64, w64 = x.double().requires_grad_(True), w.double().requires_grad_(True)
    out64 = sum(t @ w64[kk] for kk, t in enumerate(terms64(l64, x64, K))) + b.double()
    rdx, rdw = torch.autograd.grad((out64 * g.double()).sum(), (x64, w64))
    for name in variants:
        with variant(name):
            out = lg.laguerre_dense_fused(lap, x, w, b)
            dx, dw, _ = lg.laguerre_dense_fused_bwd(lap, x, w, g)
            sync()
        print(f"[errors] fused G=1 C=64 F=32 {name}: out {gap(out, out64.detach())}; "
              f"dW {gap(dw, rdw)}; dx {gap(dx, rdx)} [{card}]", flush=True)


def leaf_gaps(ours: dict, ref: dict) -> dict:
    a = {n: float(ours[n].double().norm()) for n in ref}
    b = {n: float(ref[n].double().norm()) for n in ref}
    med = float(np.median(list(b.values())))
    return {n: abs(a[n] - b[n]) / max(b[n], med, 1e-300) for n in ref}


def summary(gaps: dict) -> str:
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    return (f"median {float(np.median(list(gaps.values()))):.3e} worst {max(gaps.values()):.3e} ("
            + ", ".join(f"{n} {gaps[n]:.2e}" for n in worst) + ")")


def pred_gap(pred, ref) -> float:
    return float((pred.double() - ref).abs().max() / ref.abs().max())


def ref_pred(cfg, adapter, state, raw, prec):
    from portbench.reference import hgat_attpool as ref
    from portbench.traffic import fmri

    skel, m = fmri.skeleton(), cfg["model"]
    pyr = ref.pyramid(skel, DEVICE, m["pool_num"], m["deg_eps"])
    p = {k: v.to(prec.dtype) for k, v in state.items()}
    with torch.no_grad():
        batch = ref.make_batch(raw[0], raw[1], skel, DEVICE, prec.dtype)
        return ref.forward(p, batch, pyr, m, train=True, prec=prec)[0].double()


@contextlib.contextmanager
def recording(store: list):
    """Every ReLU and leaky ReLU input of the block, in call order."""
    import torch.nn.functional as F

    saved = (torch.relu, F.relu, F.leaky_relu)

    def rec(fn, kind):
        def run(x, *a, **k):
            store.append((kind, x.detach().clone()))
            return fn(x, *a, **k)
        return run

    torch.relu, F.relu, F.leaky_relu = (rec(saved[0], "relu"), rec(saved[1], "relu"),
                                        rec(saved[2], "leaky"))
    try:
        yield
    finally:
        torch.relu, F.relu, F.leaky_relu = saved


def census(seed, variants, card):
    """Where two variants' activation inputs fall on other sides of the kink."""
    from portbench import weights

    cfg, _, adapter = cell()
    _, batch = first_batch(seed)
    state = weights.make(adapter.param_spec(cfg), seed, DEVICE)
    runs = []
    for name in variants[:2]:
        store = []
        with variant(name), recording(store), torch.no_grad():
            adapter.program_model(cfg, state, DEVICE)(batch)
        runs.append(store)
    a, b = runs
    print(f"[census] seed {seed} {variants[0]} against {variants[1]}: {len(a)} / {len(b)} "
          f"activation calls [{card}]", flush=True)
    for i, ((kind, x), (_, y)) in enumerate(zip(a, b)):
        flip = (x > 0) != (y > 0)
        n = int(flip.sum())
        near = float(x[flip].abs().max() / x.std()) if n else 0.0
        print(f"[census] call {i} {kind} {tuple(x.shape)}: {n} of {x.numel()} on other sides, "
              f"largest |x| among them {near:.2e} std; rel diff "
              f"{float((x - y).norm() / x.norm()):.2e}", flush=True)


def model(seeds, variants, card, perturb=0):
    from portbench import weights
    from portbench.reference import ops
    from portbench.reference.train import first_steps

    cfg, _, adapter = cell()
    spec = adapter.param_spec(cfg)
    names = [n for n, _, _ in spec if not n.endswith((".running_mean", ".running_var"))]
    t = cfg["trainer"]
    trials = [(seed, 0) for seed in seeds] + [(seeds[0], i) for i in range(1, perturb + 1)]
    for seed, trial in trials:
        raw, batch = first_batch(seed)
        if trial:  # the series scaled by 1 + 1e-6·N(0, 1), both sides alike
            cfg_, mix, _ = cell()
            series, scores = raw
            noise = np.random.default_rng(trial).standard_normal(series.shape)
            raw = (series * (1 + 1e-6 * noise).astype(series.dtype), scores)
            batch = adapter.program_batch(cfg_, raw).to(DEVICE)
            seed_tag = f"{seed} perturbed {trial}"
        else:
            seed_tag = f"{seed}"
        state = weights.make(spec, seed, DEVICE)
        refs = {}
        for tag, prec in (("float64", ops.REFERENCE), ("float32", ops.Precision(torch.float32))):
            refs[tag] = first_steps(state, names, adapter.reference_loss(cfg, DEVICE, prec),
                                    [raw], lr=t["lr"], weight_decay=t["weight_decay"],
                                    prec=prec)["seen"]
        preds = {tag: ref_pred(cfg, adapter, state, raw, prec) for tag, prec in
                 (("float64", ops.REFERENCE), ("float32", ops.Precision(torch.float32)))}
        print(f"[model] seed {seed_tag} reference float32 (TF32 off): pred {pred_gap(preds['float32'], preds['float64']):.3e} "
              f"{summary(leaf_gaps(refs['float32'], refs['float64']))} [{card}]", flush=True)
        for name in variants:
            with variant(name):
                m = adapter.program_model(cfg, state, DEVICE)
                with torch.no_grad():
                    pred = m(batch)[0].reshape(-1)
                m = adapter.program_model(cfg, state, DEVICE)
                trainer = adapter.program_trainer(cfg, m, DEVICE)
                loss = float(trainer.train_step(batch))
                b1 = trainer.optimizer.param_groups[0]["betas"][0]
                grad = {n: trainer.optimizer.state[p]["exp_avg"].detach() / (1.0 - b1)
                        for n, p in m.named_parameters()}
                sync()
            print(f"[model] seed {seed_tag} {name}: loss {loss:.8f} pred {pred_gap(pred, preds['float64']):.3e} "
                  f"{summary(leaf_gaps(grad, refs['float64']))} [{card}]", flush=True)
            del m, trainer, grad
            if DEVICE != "cpu":
                torch.cuda.empty_cache()


def timing(card):
    import chip_smoke as cs
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    _, batch = first_batch(2147483705)
    lap = batch.levels[0].l1.float().contiguous()
    s = lap.shape[-1]
    for c in (16, 512, 64, 2048, 4096):
        x = seeded((1, s, c), 21)
        dt = seeded((K, 1, s, c), 22)
        fwd = cs.graph_ms(torch, lambda: lg.laguerre_terms_dense(lap, x, K), cs.KERNEL_CALLS)
        bwd = cs.graph_ms(torch, lambda: lg.laguerre_terms_dense_bwd(lap, dt, K),
                          cs.KERNEL_CALLS)
        bits = cs.bits(torch, lg.laguerre_terms_dense(lap, x, K),
                       lg.laguerre_terms_dense_bwd(lap, dt, K))
        print(f"[time] float32 G=1 S={s} C={c} K={K}: terms forward {fwd:.4f} ms, backward "
              f"{bwd:.4f} ms, bits {bits} [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("errors", "model", "time", "census"))
    ap.add_argument("--perturb", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[2147483705])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    t0 = time.perf_counter()
    if args.mode == "errors":
        errors(args.variants, card)
    elif args.mode == "model":
        model(args.seeds, args.variants, card, args.perturb)
    elif args.mode == "census":
        census(args.seeds[0], args.variants, card)
    else:
        timing(card)
    print(f"[{args.mode}] took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
