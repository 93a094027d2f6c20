#!/usr/bin/env python3
"""Convert a JAX checkpoint of the training CLI (``hl_hgat_tpu.run``, orbax
``<dir>/state`` + ``meta.json``) into the PyTorch port's checkpoint
(``hl_hgat_tpu_torch/train/checkpoint.py``: ``<dir>/state.pt`` +
``meta.json``).  Needs JAX and orbax; the port never imports this script.

    python scripts/convert_jax_checkpoint.py                      # weights/zinc_fold0
    python scripts/convert_jax_checkpoint.py --src weights/zinc_fold0 \\
        --out weights/torch/zinc_fold0 --model_only --reference
    python scripts/convert_jax_checkpoint.py --out <dir> -- \\
        --benchmark zinc --filters 64                             # JAX CLI flags

The JAX template is the JAX CLI's own: ``hl_hgat_tpu.run.make_model`` from
the CLI flags after ``--`` (default: the zinc defaults with ``--keig 4``,
the flags ``weights/zinc_fold0`` was trained with), its recipe applied
as the CLI applies it, initialized on a few synthetic samples and restored
with ``hl_hgat_tpu.train.checkpoint.restore_checkpoint``.  The port's model
comes from ``hl_hgat_tpu_torch.run.make_model`` with the same flags.

Mapped: parameters and BN statistics through ``weights.from_flax_variables``
(a ``kernel`` transposed into a torch ``weight``); the optax
``inject_hyperparams(chain(add_decayed_weights, scale_by_adam, ...))``
state into Adam's: ``mu``/``nu`` become ``exp_avg``/``exp_avg_sq`` (the
same renaming and transposes), ``count`` becomes every parameter's
``step``, the injected learning rate the optimizer's lr; ``meta.json`` is
copied.  ``TrainState.rng`` (a JAX key) has no torch counterpart and is
dropped: the port's generator and torch's stream are seeded with the fold,
as the port's CLI seeds them.  ``--model_only`` writes the ``model``
section alone (what serving and ``--test`` read).

``--reference`` also writes ``<out>/jax_reference.npz``: the JAX forward of
the restored model on ``zinc_like_samples(np.random.default_rng(0), 384,
keig=16)`` (``out``, [384, 1]) and the loss and metric the JAX CLI reports
for ``--benchmark zinc --keig 4 --synthetic --n_synthetic 128 --fold 0
--test 1``
(``cli_loss``, ``cli_metric``, unrounded), against which the port's
``chip_smoke.py`` holds its card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The flags weights/zinc_fold0 was trained with: its embedding table is
# [28, 60], filters 64 less keig 4.  At the default keig (15) orbax still
# restores it (it takes the saved shapes over the template's), but the
# forward then refuses the [28, 60] table (flax ScopeParamShapeError), in
# the JAX CLI's --test as in the port.
DEFAULT_CLI = ["--benchmark", "zinc", "--keig", "4"]
REFERENCE_GRAPHS = 384  # the served batch of chip_smoke.py
REFERENCE_TEST = ["--benchmark", "zinc", "--keig", "4", "--synthetic", "--n_synthetic",
                  "128", "--fold", "0", "--test", "1"]


def jax_args(cli_argv):
    """The JAX CLI's parsed flags (zinc defaults unless given)."""
    from hl_hgat_tpu import run as jrun

    args = jrun.build_argparser().parse_args(list(cli_argv))
    if args.benchmark == "brain":
        raise SystemExit("the brain CLI keeps its own layout; convert graph benchmarks")
    return args


def _example_samples(args, count: int = 8):
    from hl_hgat_tpu import run as jrun

    small = argparse.Namespace(**{**vars(args), "n_synthetic": count})
    return jrun.synthetic_samples(small, seed=max(args.fold, 0))


def restore_jax(src: str, args):
    """(JAX model, restored TrainState, meta) of the checkpoint in ``src``,
    restored into the JAX CLI's template for ``args``."""
    import jax
    import jax.numpy as jnp

    from hl_hgat_tpu import run as jrun
    from hl_hgat_tpu.complex.dense import collate_dense_packed
    from hl_hgat_tpu.train import Trainer, TrainerConfig
    from hl_hgat_tpu.train.checkpoint import load_metadata, restore_checkpoint

    model, _ = jrun.make_model(args)
    model = dataclasses.replace(model, cfg=dataclasses.replace(
        model.cfg, compute_dtype=args.dtype,
        remat={"0": False, "1": True, "msi": "msi", "dots": "dots"}[args.remat],
        stack_concat=args.stack_concat))
    batch = jax.tree.map(jnp.asarray, collate_dense_packed(_example_samples(args)))
    template = Trainer(model, TrainerConfig(seed=max(args.fold, 0))).init_state(batch)
    state = restore_checkpoint(src, template)
    # orbax restores the saved shapes whatever the template's: a flag that
    # differs from training shows here, not as a silently wider model
    got = jax.tree_util.tree_flatten_with_path((state.params, state.batch_stats))[0]
    want = jax.tree.leaves((template.params, template.batch_stats))
    for (path, leaf), ref in zip(got, want):
        if np.shape(leaf) != np.shape(ref):
            raise SystemExit(f"{src}: {jax.tree_util.keystr(path)} is {np.shape(leaf)}, the "
                             f"template for {args} gives {np.shape(ref)}: pass the flags "
                             f"the checkpoint was trained with")
    return model, state, load_metadata(src)


def _adam_state(opt_state):
    """(count, mu, nu, lr) of an ``adam_l2`` optax state."""
    import optax

    found = [s for s in opt_state.inner_state if isinstance(s, optax.ScaleByAdamState)]
    if len(found) != 1:
        raise ValueError(f"no single ScaleByAdamState in {type(opt_state.inner_state)}")
    adam = found[0]
    return (int(np.asarray(adam.count)), adam.mu, adam.nu,
            float(np.asarray(opt_state.hyperparams["learning_rate"])))


def port_model(args, device: str = "cpu"):
    """The port's model for the JAX CLI flags ``args`` (same widths)."""
    from hl_hgat_tpu_torch import run as prun

    s = _example_samples(args, 1)[0]
    model, _ = prun.make_model(args, in_t=s.x_t.shape[1], in_s=s.x_s.shape[1],
                               seed=max(args.fold, 0), device=device)
    return prun.with_recipe(model, compute_dtype=args.dtype, stack_concat=args.stack_concat)


def convert(state, args, *, full: bool = True):
    """The port's checkpoint sections for a restored JAX TrainState (on
    the CPU; ``full=False``: the model section alone)."""
    import torch

    from hl_hgat_tpu_torch.train.checkpoint import trainer_sections
    from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
    from hl_hgat_tpu_torch.weights import from_flax_variables

    model = port_model(args)
    model.load_state_dict(from_flax_variables(
        {"params": state.params, "batch_stats": state.batch_stats}))
    if not full:
        return {"model": model.state_dict()}
    count, mu, nu, lr = _adam_state(state.opt_state)
    seed = max(args.fold, 0)
    trainer = Trainer(model, TrainerConfig(lr=args.lr, weight_decay=args.l2, seed=seed),
                      device="cpu")
    exp_avg = from_flax_variables({"params": mu})
    exp_avg_sq = from_flax_variables({"params": nu})
    for name, p in model.named_parameters():
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].clone(),
            "exp_avg_sq": exp_avg_sq[name].clone(),
        }
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    print("convert: TrainState.rng (a JAX key) has no torch counterpart and is dropped; "
          f"the generator and torch's stream are seeded with {seed}", flush=True)
    torch.manual_seed(seed)
    return trainer_sections(trainer)


def jax_forward(model, state, samples, batch_size: int = 128) -> np.ndarray:
    """The JAX Predictor's outputs for ``samples`` (the port's samples: the
    JAX loader reads the same fields)."""
    from hl_hgat_tpu.serving import Predictor

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    return np.asarray(Predictor(model, variables, batch_size=batch_size)(samples))


def jax_cli_test(src: str) -> tuple[float, float]:
    """The loss and metric the JAX CLI's ``--test`` reports for the
    checkpoint in ``src`` (a ``<save_dir>/zinc_fold0`` directory), read
    unrounded from its ``Trainer.evaluate``."""
    from hl_hgat_tpu import run as jrun
    from hl_hgat_tpu.train import trainer as jtrainer

    src = os.path.abspath(src)
    if os.path.basename(src) != "zinc_fold0":
        raise SystemExit(f"--reference reads <save_dir>/zinc_fold0, not {src}")
    got = []
    evaluate = jtrainer.Trainer.evaluate

    def recorded(self, *a, **kw):
        got.append(evaluate(self, *a, **kw))
        return got[-1]

    jtrainer.Trainer.evaluate = recorded
    try:
        jrun.main(REFERENCE_TEST + ["--save_dir", os.path.dirname(src)])
    finally:
        jtrainer.Trainer.evaluate = evaluate
    (loss, metric), = got
    return float(loss), float(metric)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=os.path.join(ROOT, "weights", "zinc_fold0"))
    ap.add_argument("--out", default=os.path.join(ROOT, "weights", "torch", "zinc_fold0"))
    ap.add_argument("--model_only", action="store_true",
                    help="write the model section alone (serving, --test)")
    ap.add_argument("--reference", action="store_true",
                    help="also write jax_reference.npz (zinc checkpoints)")
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="JAX CLI flags after --, as the checkpoint was trained")
    opts = ap.parse_args(argv)
    cli = [a for a in opts.cli if a != "--"] or list(DEFAULT_CLI)
    if "--fold" not in cli:
        cli += ["--fold", "0"]

    import jax

    jax.config.update("jax_platforms", "cpu")
    from hl_hgat_tpu_torch.train.checkpoint import save_checkpoint

    args = jax_args(cli)
    jmodel, state, meta = restore_jax(opts.src, args)
    sections = convert(state, args, full=not opts.model_only)
    path = save_checkpoint(opts.out, sections, extra=meta)
    n = sum(v.numel() for k, v in sections["model"].items()
            if not k.endswith(("running_mean", "running_var")))
    print(f"convert: {opts.src} (step {int(np.asarray(state.step))}, meta {meta}) -> {path}: "
          f"{n} parameters, sections {sorted(sections)}, "
          f"{os.path.getsize(path) / 2**20:.2f} MiB", flush=True)
    if opts.reference:
        from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples

        samples = zinc_like_samples(np.random.default_rng(0), REFERENCE_GRAPHS, keig=16)
        out = jax_forward(jmodel, state, samples)
        loss, metric = jax_cli_test(opts.src)
        ref = os.path.join(opts.out, "jax_reference.npz")
        np.savez(ref, out=out.astype(np.float32), cli_loss=np.float64(loss),
                 cli_metric=np.float64(metric),
                 cli_argv=np.asarray(" ".join(REFERENCE_TEST + ["--save_dir", "weights"])))
        print(f"convert: {ref}: forward {out.shape}, CLI --test loss {loss!r} "
              f"metric {metric!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
