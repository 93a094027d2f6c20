"""The port's training CLI (``hl_hgat_tpu_torch/run.py``) against the JAX
CLI (``hl_hgat_tpu/run.py``) on the CPU: the flag surface, the shared
tables and helpers, the JAX ``tests/test_cli.py`` flows with ``--device
cpu``, resume, and ``--test`` on the shipped converted weights."""

import argparse
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_ingest import _fake_zinc_raw, _ring_edges  # noqa: E402

from hl_hgat_tpu import run as jrun  # noqa: E402
from hl_hgat_tpu_torch import run  # noqa: E402
from hl_hgat_tpu_torch.nn import conv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "--fold", "0", "--c1", "1", "--c2", "1", "--c3", "1", "--filters", "8",
    "--K", "2", "--mlp_channels", "1", "--layout", "packed",
    "--pack_cap", "64", "--batch_size", "4", "--epochs", "1", "--device", "cpu",
]
BENCHMARKS = ["zinc", "pepfunc", "tsp", "cifar10sp", "pascalvoc", "coco", "pcqm"]


def main(argv):
    return run.main(argv)


# ---------------------------------------------------------------------------
# the flag surface and the shared tables
# ---------------------------------------------------------------------------


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_flag_with_its_default():
    ours, ref = _actions(run.build_argparser()), _actions(jrun.build_argparser())
    assert set(ours) - set(ref) == {"device"}
    assert set(ref) <= set(ours)
    differs = {k for k in ref if ours[k].default != ref[k].default}
    assert differs == {"fused"}  # the one mapped default
    assert ours["fused"].default == 1 and ref["fused"].default == 0
    for k in ref:
        assert ours[k].choices == ref[k].choices, k
        assert ours[k].type == ref[k].type, k
        assert ours[k].option_strings == ref[k].option_strings, k


@pytest.mark.parametrize("flag,value,reason", [
    ("--prng", "rbg", "Trainer.generator"),
    ("--remat", "msi", "JAX transformation"),
    ("--swap_dw", "0", "swapped-dW"),
    ("--stack_concat", "never", "materializes"),
    ("--dp", "2", "item 13"),
])
def test_refused_flags_raise_with_their_reason(flag, value, reason):
    argv = ["--benchmark", "zinc", "--dtype", "bfloat16", flag, value] + TINY
    with pytest.raises(SystemExit, match="refused by the port") as err:
        main(argv)
    assert reason in str(err.value)
    # --help gives the reason too
    assert run.REFUSED in _actions(run.build_argparser())[flag.lstrip("-")].help


def test_swap_dw_0_is_accepted_in_float32():
    args = run.build_argparser().parse_args(["--swap_dw", "0", "--dtype", "float32"])
    assert run.refusals(args) == []
    args = run.build_argparser().parse_args(["--swap_dw", "0", "--dtype", "bfloat16"])
    assert len(run.refusals(args)) == 1


def test_help_names_the_mapped_flags():
    actions = _actions(run.build_argparser())
    assert "default 1 in the port" in actions["fused"].help
    assert "plain recurrence" in actions["fused"].help
    assert "cpu" in actions["device"].help
    assert "HLHGAT_BRAIN_DIR" in actions["rois"].help


def test_tables_equal_the_jax_cli():
    assert run.BENCH_SETTINGS == jrun.BENCH_SETTINGS
    assert run.BRAIN_DEFAULTS == jrun.BRAIN_DEFAULTS
    argv = ["--benchmark", "brain", "--batch_size", "4"]
    ours, ref = run.build_argparser().parse_args(argv), jrun.build_argparser().parse_args(argv)
    run.apply_brain_defaults(ours, argv)
    jrun.apply_brain_defaults(ref, argv)
    assert {k: v for k, v in vars(ours).items() if k not in ("device", "fused")} == \
        {k: v for k, v in vars(ref).items() if k != "fused"}
    assert ours.batch_size == 4 and ours.dtype == "bfloat16" and ours.stack_concat == "layer"


@pytest.mark.parametrize("benchmark", BENCHMARKS)
def test_synthetic_samples_draw_the_jax_arrays(benchmark):
    args = argparse.Namespace(benchmark=benchmark, n_synthetic=3)
    ours, ref = run.synthetic_samples(args, seed=4), jrun.synthetic_samples(args, seed=4)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        for f in ("x_t", "x_s", "y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert len(a.levels) == len(b.levels)
        for la, lb in zip(a.levels, b.levels):
            np.testing.assert_array_equal(la.src, lb.src)
            np.testing.assert_array_equal(la.dst, lb.dst)
            np.testing.assert_array_equal(la.l0_vals, lb.l0_vals)
            np.testing.assert_array_equal(la.l1_vals, lb.l1_vals)
        for pa, pb in zip(a.pools, b.pools):
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)


def test_resolve_layout_decides_as_the_jax_cli():
    from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample

    rng = np.random.default_rng(0)
    small = [random_simplex_sample(rng, n_nodes=10) for _ in range(3)]
    big = [random_simplex_sample(rng, n_nodes=200) for _ in range(2)]
    for layout in ("auto", "coo", "packed"):
        for ss in (small, small + big, big):
            for caps in ((128, 128), (8, 8), (512, 512)):
                assert run.resolve_layout(layout, ss, *caps) == \
                    jrun.resolve_layout(layout, ss, *caps), (layout, len(ss), caps)
    assert run.resolve_layout("auto", small, 128, 128) == "packed"
    assert run.resolve_layout("auto", small + big, 128, 128) == "coo"


def test_make_model_follows_the_flags():
    args = run.build_argparser().parse_args(
        ["--benchmark", "zinc", "--c1", "1", "--c2", "2", "--c3", "1", "--filters", "8",
         "--K", "3", "--keig", "5", "--mlp_channels", "1", "--dtype", "bfloat16"])
    model, meta = run.make_model(args, in_t=16, in_s=16, device="cpu")
    model = run.with_recipe(model, compute_dtype="bfloat16", stack_concat="layer")
    assert meta["task"] == "regression"
    assert model.cfg.channels == (1, 2, 1) and model.cfg.filters == (8, 16, 32)
    assert model.cfg.k == 3 and model.cfg.compute_dtype == "bfloat16"
    assert model.backbone.cfg.stack_concat == "layer"
    assert model.node_embedding.weight.shape == (28, 3)  # filters 8 - keig 5


# ---------------------------------------------------------------------------
# the JAX tests/test_cli.py flows on the port
# ---------------------------------------------------------------------------


def test_synthetic_train(tmp_path, capsys):
    out = main(["--benchmark", "zinc", "--synthetic", "--n_synthetic", "12",
                "--keig", "5", "--save_dir", str(tmp_path)] + TINY)
    text = capsys.readouterr().out
    assert "Epoch 001" in text and "Fold 0" in text
    assert out[0]["fold"] == 0 and len(out[0]["history"]) == 1
    assert conv.use_fused_dense()  # the flag is put back


def test_data_root_train_resume_and_test(tmp_path, capsys):
    root = str(tmp_path / "raw")
    _fake_zinc_raw(root, n_mols=10)
    save = str(tmp_path / "w")
    args = ["--benchmark", "zinc", "--data_root", root, "--keig", "5",
            "--save_dir", save] + TINY
    main(args)
    # no gated checkpoint (random labels) -> --test fails loudly
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(args + ["--test", "1"])
    # --resume with nothing saved starts from scratch without error
    main(args + ["--resume", "1"])
    assert "Epoch 001" in capsys.readouterr().out


def test_layout_auto_picks_packed(tmp_path, capsys):
    tiny = list(TINY)
    i = tiny.index("--layout")
    del tiny[i:i + 2]  # the default, auto
    main(["--benchmark", "zinc", "--synthetic", "--n_synthetic", "12",
          "--keig", "5", "--save_dir", str(tmp_path)] + tiny)
    out = capsys.readouterr().out
    assert "--layout auto -> packed" in out and "Epoch 001" in out


@pytest.mark.parametrize("model", ["hgat", "abcd"])
def test_brain_train_and_test(tmp_path, capsys, model):
    args = ["--benchmark", "brain", "--brain_model", model, "--fold", "0",
            "--n_synthetic", "12", "--batch_size", "4", "--epochs", "1", "--c1", "1",
            "--c2", "1", "--c3", "1", "--filters", "8", "--K", "2", "--t", "24",
            "--crop_len", "16", "--rois", "24", "--dtype", "float32",
            "--save_dir", str(tmp_path), "--device", "cpu"]
    if model == "abcd":
        args += ["--pool_num", "1"]
    main(args)
    out = capsys.readouterr().out
    assert "synthetic skeleton" in out and "Epoch 001" in out
    # the brain loop saves on every improvement (no gate)
    assert os.path.exists(tmp_path / "brain_fold0" / "state.pt")
    res = main(args + ["--test", "1"])
    out = capsys.readouterr().out
    assert "test corr=" in out and np.isfinite(res[0]["rmse"])


def test_pascalvoc_synthetic(tmp_path, capsys):
    main(["--benchmark", "pascalvoc", "--synthetic", "--n_synthetic", "12", "--keig", "5",
          "--fold", "0", "--c1", "1", "--c2", "1", "--c3", "1", "--filters", "8", "--K", "2",
          "--mlp_channels", "1", "--batch_size", "4", "--epochs", "1",
          "--save_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Epoch 001" in out and "Fold 0" in out


def test_four_benchmark_gate_rehearsal(tmp_path, capsys):
    """Ingest, fold, train, test and gate on fabricated raw files for the
    four reference benchmarks."""
    rng = np.random.default_rng(0)
    root = str(tmp_path / "raw")
    os.makedirs(root, exist_ok=True)
    _fake_zinc_raw(root, n_mols=8)
    for split in ("train", "val"):
        graphs = []
        for _ in range(6):
            n = 12
            ei = _ring_edges(n)
            graphs.append(dict(pos=rng.random((n, 2)).astype(np.float32), edge_index=ei,
                               edge_attr=rng.random(ei.shape[1]).astype(np.float32),
                               y=(rng.random(ei.shape[1]) > 0.5).astype(np.float32)))
        with open(os.path.join(root, f"tsp_{split}.pkl"), "wb") as f:
            pickle.dump(graphs, f)
        graphs = []
        for _ in range(6):
            n = 16
            ei = _ring_edges(n)
            graphs.append(dict(x=rng.random((n, 3)).astype(np.float32),
                               pos=rng.random((n, 2)).astype(np.float32), edge_index=ei,
                               edge_attr=rng.random(ei.shape[1]).astype(np.float32),
                               y=np.asarray([int(rng.integers(0, 10))])))
        with open(os.path.join(root, f"cifar10sp_{split}.pkl"), "wb") as f:
            pickle.dump(graphs, f)
    praw = os.path.join(root, "peptides-func", "raw")
    os.makedirs(praw, exist_ok=True)
    for split in ("train", "val"):
        gs = []
        for _ in range(6):
            n = 12
            ei = _ring_edges(n)
            gs.append((torch.tensor(rng.random((n, 9)), dtype=torch.float32),
                       torch.tensor(rng.random((ei.shape[1], 3)), dtype=torch.float32),
                       torch.tensor(ei),
                       torch.tensor(rng.integers(0, 2, (1, 10)), dtype=torch.float32)))
        torch.save(gs, os.path.join(praw, f"{split}.pt"))
    for bench in ("zinc", "tsp", "cifar10sp", "pepfunc"):
        args = ["--benchmark", bench, "--data_root", root, "--keig", "5",
                "--aug_variants", "1", "--save_dir", str(tmp_path / "w"), "--fold", "0",
                "--c1", "1", "--c2", "1", "--c3", "1", "--filters", "8", "--K", "2",
                "--mlp_channels", "1", "--batch_size", "4", "--epochs", "2",
                "--device", "cpu"]
        main(args)
        out = capsys.readouterr().out
        assert "Fold 0 best metric" in out, (bench, out)
        # --test restores a gate-passing checkpoint and prints the metric,
        # or (random labels usually fail the gate) exits loudly
        try:
            main(args + ["--test", "1"])
            assert "metric=" in capsys.readouterr().out, bench
        except SystemExit as e:
            assert "no checkpoint" in str(e), (bench, e)


def test_pcqm_synthetic_train_and_test(tmp_path, capsys):
    args = ["--benchmark", "pcqm", "--synthetic", "--n_synthetic", "24", "--keig", "5",
            "--fold", "0", "--c1", "1", "--c2", "1", "--c3", "1", "--filters", "8",
            "--K", "2", "--mlp_channels", "1", "--batch_size", "4",
            "--save_dir", str(tmp_path), "--device", "cpu"]
    res = main(args + ["--epochs", "8"])
    out = capsys.readouterr().out
    assert "Epoch 001" in out and "Fold 0 best metric" in out
    # MRR over (1 pos, 8 neg) groups: chance E[1/rank] ≈ 0.314; the eig-PE
    # adjacency signal lifts it.  The val split holds 2 graphs, so the
    # epoch's MRR is noisy: the JAX test's 4 epochs pass 0.45 from flax's
    # init (0.453 at epoch 2), the port's seeded init passes it at epoch 6
    # (0.558) on a train loss within 1 % of the JAX run's each epoch
    history = res[0]["history"]
    assert history[-1]["train_loss"] < 0.6 * history[0]["train_loss"]
    assert res[0]["best_metric"] > 0.45, out
    res = main(args + ["--test", "1"])
    out = capsys.readouterr().out
    assert "metric=" in out and "val" in out and 0 < res[0]["metric"] <= 1


def test_tsp_aug_variants_roundtrip(tmp_path, capsys):
    root = str(tmp_path / "raw")
    os.makedirs(root)
    rng = np.random.default_rng(1)
    graphs = []
    for _ in range(12):
        n = 14
        ei = _ring_edges(n)
        y = np.zeros(ei.shape[1], np.float32)
        y[: n // 2] = 1.0
        graphs.append(dict(pos=rng.random((n, 2)).astype(np.float32), edge_index=ei,
                           edge_attr=rng.random(ei.shape[1]).astype(np.float32), y=y))
    with open(os.path.join(root, "tsp_train.pkl"), "wb") as f:
        pickle.dump(graphs, f)
    main(["--benchmark", "tsp", "--data_root", root, "--aug_variants", "3",
          "--save_dir", str(tmp_path / "w")] + TINY)
    assert "Epoch 001" in capsys.readouterr().out


def test_fused_0_selects_the_plain_recurrence(tmp_path, monkeypatch):
    seen = []
    real = conv.use_fused_dense

    def spy(enable=None):
        if enable is None:
            seen.append(real())
        return real(enable)

    monkeypatch.setattr(conv, "use_fused_dense", spy)
    main(["--benchmark", "zinc", "--synthetic", "--n_synthetic", "12", "--keig", "5",
          "--save_dir", str(tmp_path), "--fused", "0"] + TINY)
    assert False in seen and real() is True


# ---------------------------------------------------------------------------
# resume and the shipped weights
# ---------------------------------------------------------------------------


def test_resume_equals_a_straight_run(tmp_path, capsys):
    """2 epochs, then --resume to 3, against 3 straight: epoch 3 equal bit
    for bit on the CPU (dropout on, PE flips, derived transfer, shuffled
    loaders positioned at the resumed epoch)."""
    base = ["--benchmark", "zinc", "--synthetic", "--n_synthetic", "40", "--keig", "5",
            "--ckpt_every", "1", "--dropout_ratio", "0.2"] + TINY[:-4] + TINY[-2:]
    straight = main(base + ["--epochs", "3", "--save_dir", str(tmp_path / "a")])
    main(base + ["--epochs", "2", "--save_dir", str(tmp_path / "b")])
    capsys.readouterr()
    resumed = main(base + ["--epochs", "3", "--resume", "1", "--save_dir",
                           str(tmp_path / "b")])
    assert "resumed from epoch 2" in capsys.readouterr().out
    a, b = straight[0]["history"][2], resumed[0]["history"][0]
    assert a["epoch"] == b["epoch"] == 3
    for key in ("train_loss", "val_loss", "val_metric", "lr"):
        assert a[key] == b[key], key


def test_test_on_the_shipped_weights_reports_the_jax_numbers(tmp_path, capsys):
    """``--test`` on the converted ``weights/zinc_fold0`` reports the loss
    and metric the JAX CLI reports on the JAX checkpoint (its keig: the
    embedding table is [28, 60])."""
    save = tmp_path / "weights"
    shutil.copytree(os.path.join(ROOT, "weights", "torch", "zinc_fold0"),
                    save / "zinc_fold0")
    ref = np.load(os.path.join(ROOT, "weights", "torch", "zinc_fold0", "jax_reference.npz"))
    argv = ["--benchmark", "zinc", "--keig", "4", "--synthetic", "--n_synthetic", "128",
            "--fold", "0", "--test", "1", "--save_dir", str(save), "--device", "cpu"]
    assert str(ref["cli_argv"]).split()[:-2] == argv[:11]
    (res,) = main(argv)
    assert res["epoch"] == 1
    np.testing.assert_allclose(res["loss"], float(ref["cli_loss"]), rtol=1e-4)
    np.testing.assert_allclose(res["metric"], float(ref["cli_metric"]), rtol=1e-4)
    out = capsys.readouterr().out
    assert "Fold 0 val loss=" in out and "(epoch 1 best)" in out
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(argv[:-4] + ["--save_dir", str(tmp_path / "empty"), "--device", "cpu"])
