"""Training entry point of the port (``hl_hgat_tpu/run.py``): the reference's
``main_*.py`` scripts as one CLI, on the CUDA card.

    python -m hl_hgat_tpu_torch.run --benchmark zinc --c1 2 --c2 3 --c3 3 --K 6 \\
        --batch_size 256 --lr 1e-3 --l2 1e-3 --epochs 600
    python -m hl_hgat_tpu_torch.run --benchmark zinc --synthetic --fold 0 --test 1 \\
        --save_dir weights/torch

Every flag of the JAX CLI, with the same name and default; 5-fold seed
loops, ReduceLROnPlateau, metric-gated checkpointing, ``--ckpt_every`` /
``--resume`` and the early-stop-on-lr rule are kept.  Without a
``--data_root`` holding the real benchmark, ``--synthetic`` trains on
benchmark-shaped synthetic data (the same arrays as the JAX CLI's for a
seed).  The checkpoints are the port's (``train/checkpoint.py``) under
``<save_dir>/<benchmark>_fold<k>``; ``scripts/convert_jax_checkpoint.py``
converts a JAX one.

Flags for a JAX mechanism are mapped or refused, each with its reason in
``--help``: ``--prng rbg``, ``--remat`` other than 0, ``--swap_dw 0`` in
bfloat16 and ``--stack_concat never`` are refused; ``--fused``
defaults to 1 (the fused CUDA kernel is the port's conv route on the card)
and ``--fused 0`` selects the plain recurrence; ``--rois 0`` finds the
reference's group data in ``$HLHGAT_BRAIN_DIR``.  ``--device`` (new) names
the device: the card by default, ``cpu`` on request, never a fallback.

``--dp N`` trains data-parallel over N ranks, one process each
(``parallel/dp_trainer.py``), with ``--batch_size`` per rank as in the JAX
CLI: under torchrun the CLI joins its ranks (``WORLD_SIZE`` must be N),
otherwise it starts N local ranks itself.  The backend is NCCL when every
rank has a card of its own and gloo when ranks share one
(``parallel/distributed.py``).

    torchrun --nproc_per_node 4 -m hl_hgat_tpu_torch.run --dp 4 --benchmark zinc ...
    python -m hl_hgat_tpu_torch.run --dp 2 --benchmark zinc ...   # 2 local ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

REFUSED = "refused by the port"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--benchmark", default="zinc",
                   choices=["zinc", "pepfunc", "tsp", "cifar10sp", "brain",
                            "pascalvoc", "coco", "pcqm"])
    p.add_argument("--c1", type=int, default=2)
    p.add_argument("--c2", type=int, default=3)
    p.add_argument("--c3", type=int, default=3)
    p.add_argument("--filters", type=int, default=64)
    p.add_argument("--mlp_channels", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--l2", type=float, default=1e-3)
    p.add_argument("--dropout_ratio", type=float, default=0.0)
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--keig", type=int, default=0,
                   help="PE dims (0 = benchmark default, capped below filters)")
    p.add_argument("--batch_size", type=int, default=128,
                   help="default 128 = the reference scripts' training batch")
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--fold", type=int, default=-1)
    p.add_argument("--test", type=int, default=0,
                   help="evaluate the fold's best checkpoint instead of training "
                        "(exits with 'no checkpoint' when there is none)")
    p.add_argument("--aug_variants", type=int, default=-1,
                   help="CIFAR10-SP structure augmentation: preprocess N independent "
                        "dropout rolls per training graph and cycle one per epoch "
                        "(-1 = auto: 8 for the cifar10sp train split, else 1.  TSP "
                        "instead uses the per-step dropout on the device "
                        "(--tsp_aug_prob); an explicit N>1 for tsp switches it to "
                        "host-side variants)")
    p.add_argument("--tsp_aug_prob", type=float, default=0.75,
                   help="TSP structure augmentation on the device: probability a graph "
                        "gets a label-protected edge-simplex dropout roll each step "
                        "(reference aug_prob, main_TSP...py:404; 0 = off)")
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="also save the full state every N epochs to <ckpt_dir>/latest "
                        "(crash recovery; 0 = off)")
    p.add_argument("--resume", type=int, default=0,
                   help="resume the fold from its newest checkpoint (full state: "
                        "params, optimizer, random streams, the plateau's lr; its "
                        "loaders continue at the resumed epoch)")
    p.add_argument("--data_root", default=None)
    p.add_argument("--limit_samples", type=int, default=0,
                   help="truncate each real-data split after N graphs (0 = full split)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n_synthetic", type=int, default=512)
    p.add_argument("--save_dir", default="./weights")
    p.add_argument("--layout", default="auto", choices=["auto", "coo", "packed"],
                   help="batch layout: auto (packed dense superblocks wherever every "
                        "graph fits the pack caps, else coo), coo (the flat layout), "
                        "or packed")
    p.add_argument("--pack_cap", type=int, default=128,
                   help="node/edge capacity of one packed superblock")
    p.add_argument("--edge_cap", type=int, default=0,
                   help="edge capacity override for packed superblocks (0 = same as "
                        "--pack_cap)")
    p.add_argument("--transfer", default="derived", choices=["dense", "compact", "derived"],
                   help="packed-layout transfer format: derived (default) ships B1 and "
                        "the spectral scales and rebuilds L0/L1/deg on the card, compact "
                        "ships COO operator triplets, dense ships ready blocks")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation compute dtype")
    p.add_argument("--swap_dw", default="auto", choices=["auto", "0", "1"],
                   help="the stack-GEMM backward: the port has one, the JAX package's "
                        "swapped-dW formulation (nn/gemm.py), so auto and 1 select it; "
                        f"0 is {REFUSED} in bfloat16 (in float32 both settings give "
                        "the same gradients)")
    p.add_argument("--prng", default="threefry2x32", choices=["threefry2x32", "rbg"],
                   help="a JAX generator for the training stream; the port draws from "
                        f"Trainer.generator and torch's stream, so rbg is {REFUSED}")
    p.add_argument("--remat", default="0", choices=["0", "1", "msi", "dots"],
                   help="backward rematerialization, a JAX transformation: anything "
                        f"but 0 is {REFUSED}")
    p.add_argument("--stack_concat", default="block", choices=["layer", "block", "never"],
                   help="dense-concat stack materialization granularity "
                        f"(models/backbone.py); never is {REFUSED}: the port's backbone "
                        "always materializes the stacks")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: >1 trains through DataParallelTrainer "
                        "(parallel/dp_trainer.py), one process a rank (torchrun's, or N "
                        "local ranks started here; NCCL when each rank has its own card, "
                        "gloo when they share one); --batch_size is per rank")
    p.add_argument("--fused", type=int, default=1,
                   help="dense-layout Laguerre convs through the fused CUDA kernel: "
                        "default 1 in the port (its default conv route on the card, "
                        "nn/conv.py; the JAX CLI defaults to 0 for its Pallas kernel); "
                        "0 selects the plain recurrence")
    # brain benchmark only (the OHBM workflow, reference
    # HL-HGAT-DEMO/OHBM_DEMO.ipynb cells 36-43)
    p.add_argument("--pool_num", type=int, default=2,
                   help="brain: MLGC_Weight pooling levels (notebook: 2)")
    p.add_argument("--t", type=int, default=128,
                   help="brain: synthetic fMRI series length")
    p.add_argument("--crop_len", type=int, default=0,
                   help="brain: temporal crop augmentation length (0 = full series)")
    p.add_argument("--rois", type=int, default=0,
                   help="brain: 0 = auto (the real Shen-268 skeleton and MLGC_Weight "
                        "pyramid from the reference's group data in the directory "
                        "$HLHGAT_BRAIN_DIR names, when set, else 32 synthetic ROIs); "
                        "N>0 forces an N-ROI synthetic skeleton")
    p.add_argument("--brain_model", default="hgat", choices=["hgat", "abcd"],
                   help="brain: hgat = the DEMO HL_HGAT_attpool (default); abcd = the "
                        "lib ABCD model on the same shared-skeleton pyramid")
    p.add_argument("--device", default=None,
                   help="the port's device: the CUDA card by default, cpu on request; "
                        "without a card and without --device cpu the run raises")
    return p


# flags a `--benchmark brain` run re-defaults to the benched recipe and the
# notebook's hyperparameters (OHBM_DEMO.ipynb cell 40: lr=l2=1e-4; cell 36
# model widths); explicit command-line values always win
BRAIN_DEFAULTS = dict(
    c2=2, c3=2, K=4, batch_size=16, dtype="bfloat16",
    lr=1e-4, l2=1e-4, mlp_channels=1, stack_concat="layer",
)


def apply_brain_defaults(args, argv) -> None:
    passed = set()
    for a in (argv if argv is not None else sys.argv[1:]):
        if isinstance(a, str) and a.startswith("--"):
            passed.add(a.lstrip("-").split("=")[0])
    for k, v in BRAIN_DEFAULTS.items():
        if k not in passed:
            setattr(args, k, v)


BENCH_SETTINGS = {
    # (preset kwargs builder, TrainerConfig kwargs) — gates from SURVEY.md §6.
    # pe_static = leading non-PE feature columns (node, edge): the PE sign
    # flips on the card (TrainerConfig.pe_flip_*); TSP carries no PE and
    # takes its structure augmentation on the card (tsp_aug_prob); CIFAR's
    # edge dropout stays host-side via --aug_variants.
    "zinc": dict(task="regression", metric_mode="min", save_gate=0.4,
                 denorm=2.0109, patience=10, pe_static=(1, 1)),
    "pepfunc": dict(task="multilabel", metric_mode="max", save_gate=0.5,
                    patience=10, pe_static=(9, 3)),
    "tsp": dict(task="edge_binary", metric_mode="max", save_gate=0.75,
                patience=5, pe_static=None),
    "cifar10sp": dict(task="classification", metric_mode="max", save_gate=0.6,
                      patience=5, pe_static=(5, 4)),
    # beyond-reference LRGB node-classification heads; save gates are the
    # JAX package's (macro-F1, no published floor)
    "pascalvoc": dict(task="node_classification", metric_mode="max",
                      save_gate=None, patience=10, pe_static=(14, 2)),
    "coco": dict(task="node_classification", metric_mode="max",
                 save_gate=None, patience=10, pe_static=(14, 2)),
    # beyond-reference PCQM-Contact link prediction; metric = MRR over
    # (1 pos, 8 neg) query groups
    "pcqm": dict(task="link_prediction", metric_mode="max", save_gate=None,
                 patience=10, pe_static=(6, 4)),
}


def refusals(args) -> list[str]:
    """Why the port cannot honour the given flags (empty: it can)."""
    out = []
    if args.prng != "threefry2x32":
        out.append(f"--prng {args.prng}: the port's random draws come from "
                   "Trainer.generator and torch's stream, not a JAX generator")
    if args.remat != "0":
        out.append(f"--remat {args.remat}: rematerialization is a JAX transformation")
    if args.swap_dw == "0" and args.dtype == "bfloat16":
        out.append("--swap_dw 0 in bfloat16: the port's one stack-GEMM backward is the "
                   "swapped-dW formulation (nn/gemm.py)")
    if args.stack_concat == "never":
        out.append("--stack_concat never: the port's backbone materializes the stacks "
                   "per block or per layer (models/backbone.py)")
    return out


def make_model(args, in_t: int | None = None, in_s: int | None = None, *, seed: int = 0,
               device=None):
    """The benchmark's preset at the CLI's widths: (model, meta).  ``in_t``
    / ``in_s`` are the samples' raw feature widths (a torch module needs
    them at construction, where flax reads them from the first batch);
    None keeps the preset's default.  ``seed`` seeds the initial weights
    (the JAX trainer initializes from the fold's seed)."""
    from hl_hgat_tpu_torch.models import presets

    channels = (args.c1, args.c2, args.c3)
    filters = (args.filters, args.filters * 2, args.filters * 4)
    mlp = () if args.mlp_channels == 0 else (256,) * args.mlp_channels
    kw = dict(seed=seed, device=device, compute_dtype=args.dtype)
    if in_t is not None:
        kw["in_t"] = in_t
    if in_s is not None:
        kw["in_s"] = in_s
    if args.benchmark == "zinc":
        keig = args.keig or min(15, args.filters - 1)
        return presets.zinc_pyr(channels=channels, filters=filters, k=args.K,
                                keig=keig, dropout=args.dropout_ratio,
                                mlp_channels=mlp, **kw)
    if args.benchmark == "pepfunc":
        return presets.pepfunc_attpool(
            channels=channels, filters=filters, k=args.K,
            dropout=args.dropout_ratio, mlp_channels=mlp or (256,), **kw)
    if args.benchmark == "tsp":
        return presets.tsp_pyr(channels=channels, filters=filters, k=args.K,
                               dropout=args.dropout_ratio,
                               mlp_channels=mlp[:1] or (256,), **kw)
    if args.benchmark in ("pascalvoc", "coco"):
        fn = presets.pascalvoc_node if args.benchmark == "pascalvoc" else presets.coco_node
        return fn(channels=channels, filters=filters, k=args.K,
                  dropout=args.dropout_ratio, mlp_channels=mlp[:1] or (128,), **kw)
    if args.benchmark == "pcqm":
        return presets.pcqm_link(channels=channels, filters=filters, k=args.K,
                                 dropout=args.dropout_ratio,
                                 mlp_channels=mlp[:1] or (128,), **kw)
    return presets.cifar10sp_attpool(
        channels=channels, filters=filters, k=args.K,
        dropout=args.dropout_ratio, mlp_channels=mlp or (256,), **kw)


def with_recipe(model, **changes):
    """Apply the CLI's recipe fields (``compute_dtype``, ``stack_concat``)
    to every ``BackboneConfig`` the model holds, as the JAX CLI replaces the
    module's ``cfg``."""
    from hl_hgat_tpu_torch.models.backbone import BackboneConfig

    for module in model.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, BackboneConfig):
            module.cfg = dataclasses.replace(cfg, **changes)
    return model


def resolve_layout(layout: str, samples, node_cap: int, edge_cap: int) -> str:
    """``auto`` → ``packed`` iff every graph (every level) fits one
    superblock, else ``coo``."""
    if layout != "auto":
        return layout
    for s in samples:
        for lv in s.levels:
            if lv.num_nodes > node_cap or lv.num_edges > edge_cap:
                return "coo"
    return "packed"


def synthetic_samples(args, seed: int):
    """The JAX CLI's synthetic samples: the same generator calls, so the
    same arrays for one seed."""
    from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample

    rng = np.random.default_rng(seed)
    samples = []
    num_pool = 1 if args.benchmark in ("pepfunc", "cifar10sp") else 0
    if args.benchmark in ("pascalvoc", "coco"):
        # fixed random projection → learnable per-node labels
        n_classes = 21 if args.benchmark == "pascalvoc" else 81
        label_w = np.random.default_rng(7).standard_normal((14, n_classes))
    for _ in range(args.n_synthetic):
        if args.benchmark == "zinc":
            s = random_simplex_sample(rng, n_nodes=int(rng.integers(15, 33)),
                                      node_feat=1, edge_feat=1, keig=16)
            s.x_t[:, 0] = rng.integers(0, 28, s.x_t.shape[0])
            s.x_s[:, 0] = rng.integers(0, 4, s.x_s.shape[0])
        elif args.benchmark == "tsp":
            s = random_simplex_sample(rng, n_nodes=int(rng.integers(50, 100)),
                                      node_feat=2, edge_feat=2, keig=0)
            s.x_s[:, -1] = 1.0
            s.y = (rng.random(s.num_edges) > 0.8).astype(np.float32)
        elif args.benchmark in ("pascalvoc", "coco"):
            s = random_simplex_sample(
                rng, n_nodes=int(rng.integers(30, 80)), node_feat=14,
                edge_feat=2, keig=10,
            )
            s.y = np.argmax(
                s.x_t[:, :14] @ label_w, axis=1
            ).astype(np.float32).reshape(-1, 1)
        elif args.benchmark == "pcqm":
            # link-prediction proxy: adjacency is recoverable from the
            # eig-PE columns; per-batch query pairs come from the loader
            s = random_simplex_sample(
                rng, n_nodes=int(rng.integers(14, 30)), node_feat=6,
                edge_feat=4, keig=6,
            )
        else:
            s = random_simplex_sample(
                rng, n_nodes=int(rng.integers(20, 60)), node_feat=9,
                edge_feat=3, keig=10, num_pool=num_pool,
                y_dim=10 if args.benchmark == "pepfunc" else 1,
            )
            if args.benchmark == "pepfunc":
                s.y = (s.y > 0).astype(np.float32)
            else:
                s.y = np.asarray([int(abs(s.y[0]) * 7) % 10], np.float32)
        samples.append(s)
    return samples


def _no_checkpoint(ckpt_dir: str) -> SystemExit:
    return SystemExit(f"--test: no checkpoint under {ckpt_dir} — train first (or point "
                      f"--save_dir at the trained weights)")


def run_brain(args, device) -> list[dict]:
    """The OHBM brain training loop (HL-HGAT-DEMO/OHBM_DEMO.ipynb cells
    36-43): shared-skeleton dense layout, ``BrainLoader`` crop
    augmentation, the Trainer's plateau, gated checkpoints and
    ``--resume``, and ``BrainPredictor`` for ``--test``.

    Structure: the real Shen-268 skeleton and MLGC_Weight pyramid from the
    reference's group data in ``$HLHGAT_BRAIN_DIR`` when set (``--rois
    0``); otherwise a synthetic skeleton from the subjects' FC via
    ``fc2mask`` (notebook cell 18).  Series: ``--data_root`` npz
    (``timeseries`` [N,R,T] + ``scores`` [N]), else learnable synthetic
    fMRI."""
    import torch

    from hl_hgat_tpu_torch.complex.build import build_structure
    from hl_hgat_tpu_torch.complex.coarsen import mlgc
    from hl_hgat_tpu_torch.data import brain as brain_data
    from hl_hgat_tpu_torch.data.datasets import fc2mask
    from hl_hgat_tpu_torch.data.synthetic import synthetic_fmri_series
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import BrainPredictor
    from hl_hgat_tpu_torch.train import TrainerConfig
    from hl_hgat_tpu_torch.train.metrics import pearson_corr

    rng = np.random.default_rng(0)
    real_dir_ok = brain_data.reference_data_available()
    if args.data_root:
        path = args.data_root
        if os.path.isdir(path):
            path = os.path.join(path, "brain.npz")
        z = np.load(path)
        ts_all, scores = z["timeseries"], z["scores"]
        rois = ts_all.shape[1]
    else:
        rois = 268 if (args.rois == 0 and real_dir_ok) else (args.rois or 32)
        ts_all, scores = synthetic_fmri_series(rng, args.n_synthetic, rois, args.t)
    use_real = args.rois == 0 and real_dir_ok and rois == 268
    if use_real:
        levels, pools, _ = brain_data.build_real_brain_pyramid(pool_num=args.pool_num)
        print(f"REAL skeleton: {rois} ROIs, {levels[0].num_edges} edges "
              f"(level-1 n+e = {levels[1].num_nodes + levels[1].num_edges})")
    else:
        # notebook cell 18: group FC -> fc2mask skeleton; then the
        # MLGC_Weight pyramid (prune single-fine-edge coarse edges, drop
        # isolated nodes) weighted by |mean FC|
        fcs = np.stack([np.corrcoef(ts) for ts in ts_all])
        mask = fc2mask(fcs, percent=0.2, mode=1)
        src, dst = np.nonzero(mask)
        order = np.argsort(src * mask.shape[0] + dst)
        src = src[order].astype(np.int32)
        dst = dst[order].astype(np.int32)
        levels = [build_structure(src, dst, rois)]
        pools = []
        weight = np.abs(fcs.mean(0))[src, dst]
        for _ in range(args.pool_num):
            step = mlgc(levels[-1], edge_weight=weight, prune_single_fine_edges=True,
                        drop_isolated_nodes=True)
            levels.append(step.structure)
            pools.append((step.c_node, step.c_edge))
            weight = None
        print(f"synthetic skeleton: {rois} ROIs, {levels[0].num_edges} edges")

    t_full = ts_all.shape[-1]
    crop = args.crop_len if 0 < args.crop_len < t_full else None
    n_val = max(len(ts_all) // 5, 1)  # notebook: 40 train / 10 test
    folds = [args.fold] if args.fold >= 0 else list(range(args.folds))
    final = levels[args.pool_num]
    if final.num_nodes == 0:
        raise SystemExit(
            "brain pyramid collapsed to 0 nodes (MLGC_Weight pruning on a too-sparse "
            "skeleton) — increase --rois or lower --pool_num")
    results = []
    for fold in folds:
        print(f"Fold {fold} begin")
        mlp = (64,) * max(args.mlp_channels, 1)
        common = dict(channels=(args.c1, args.c2, args.c3),
                      filters=(args.filters // 2, args.filters, args.filters * 2),
                      k=args.K, dropout=args.dropout_ratio, mlp_channels=mlp,
                      pool_num=args.pool_num, nodes_per_graph=final.num_nodes,
                      edges_per_graph=final.num_edges, compute_dtype=args.dtype,
                      seed=fold, device=device)
        if args.brain_model == "abcd":
            model, meta = presets.abcd_attpool(**common)
        else:
            model, meta = presets.hgat_attpool(
                fine_nodes_per_graph=levels[0].num_nodes,
                fine_edges_per_graph=levels[0].num_edges, **common)
        model = with_recipe(model, compute_dtype=args.dtype, stack_concat=args.stack_concat)
        cfg = TrainerConfig(
            task="brain", lr=args.lr, weight_decay=args.l2, plateau_patience=10,
            metric_mode="max", save_gate=None, denorm=meta["y_std"],
            ckpt_dir=os.path.join(args.save_dir, f"brain_fold{fold}"),
            ckpt_every=args.ckpt_every, seed=fold,
        )
        trainer = _make_trainer(args, model, cfg, device)
        torch.manual_seed(fold)  # dropout's stream, as in the graph branch

        perm = np.random.default_rng(fold).permutation(len(ts_all))
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        train_loader = brain_data.BrainLoader(
            [ts_all[i] for i in train_idx], scores[train_idx], levels, pools,
            args.batch_size, crop_len=crop, shuffle=True, seed=fold,
            y_mean=meta["y_mean"], y_std=meta["y_std"])
        val_loader = brain_data.BrainLoader(
            [ts_all[i] for i in val_idx], scores[val_idx], levels, pools,
            min(args.batch_size, n_val), crop_len=None, shuffle=False,
            drop_last=False, y_mean=meta["y_mean"], y_std=meta["y_std"])
        if len(train_loader) == 0:
            raise SystemExit(f"batch_size {args.batch_size} exceeds the "
                             f"{len(train_idx)}-subject train split")
        if args.test:
            start = trainer.maybe_restore(prefer="best")
            if start == 1:
                raise _no_checkpoint(cfg.ckpt_dir)
            predictor = BrainPredictor(trainer.model, levels, pools,
                                       batch_size=min(args.batch_size, n_val), device=device)
            out = predictor([ts_all[i] for i in val_idx])
            yz = (scores[val_idx] - meta["y_mean"]) / meta["y_std"]
            pred = out["pred"].reshape(-1)
            corr = float(pearson_corr(torch.from_numpy(pred).double(),
                                      torch.from_numpy(yz).double()))
            rmse = float(np.sqrt(np.mean((pred - yz) ** 2))) * meta["y_std"]
            print(f"Fold {fold} test corr={corr:.4f} RMSE={rmse:.4f} "
                  f"(epoch {start - 1} best)")
            results.append(dict(fold=fold, corr=corr, rmse=rmse, epoch=start - 1))
            continue
        trainer.fit(lambda: train_loader, lambda: val_loader, epochs=args.epochs,
                    resume=bool(args.resume))
        print(f"Fold {fold} best metric: {trainer.best_metric:.4f}")
        results.append(dict(fold=fold, best_metric=trainer.best_metric,
                            history=trainer.history))
    return results


def main(argv=None) -> list[dict]:
    """Run the CLI; returns one dict a fold (``--test``: its loss, metric
    and checkpoint epoch; training: its best metric and epoch history)."""
    args = build_argparser().parse_args(argv)
    if args.benchmark == "brain":
        apply_brain_defaults(args, argv)  # may re-default --dtype
    refused = refusals(args)
    if refused:
        raise SystemExit("refused by the port:\n  " + "\n  ".join(refused))
    from hl_hgat_tpu_torch.device import resolve_device
    from hl_hgat_tpu_torch.nn import conv

    if args.dp > 1:
        import torch.distributed as dist

        from hl_hgat_tpu_torch.parallel import distributed as pdist

        device_type = resolve_device(args.device).type  # no card and no --device cpu: raise
        if not dist.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                # N local ranks, each running this CLI; rank 0's results
                return pdist.spawn_ranks(_dp_rank_main, args.dp,
                                         sys.argv[1:] if argv is None else argv,
                                         device_type=device_type, timeout=None)[0]
            pdist.init_distributed(device_type=device_type)
        if dist.get_world_size() != args.dp:
            raise SystemExit(f"--dp {args.dp} under a process group of "
                             f"{dist.get_world_size()} ranks")
        device = pdist.rank_device()
    else:
        device = resolve_device(args.device)
    fused_before = conv.use_fused_dense()
    conv.use_fused_dense(bool(args.fused))
    try:
        if args.benchmark == "brain":
            return run_brain(args, device)
        return _run_graph(args, device)
    finally:
        conv.use_fused_dense(fused_before)


def _dp_rank_main(rank: int, world: int, argv) -> list[dict]:
    """One local rank of ``--dp``: this CLI inside the rank's process group."""
    return main(argv)


def _make_trainer(args, model, cfg, device):
    """The fold's trainer: ``DataParallelTrainer`` with ``--dp`` > 1."""
    from hl_hgat_tpu_torch.train import Trainer

    if args.dp > 1:
        from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer

        return DataParallelTrainer(model, cfg, device=device)
    return Trainer(model, cfg, device=device)


def _run_graph(args, device) -> list[dict]:
    import torch

    from hl_hgat_tpu_torch.data.loader import BucketedLoader
    from hl_hgat_tpu_torch.train import TrainerConfig

    if args.aug_variants == -1:  # auto: reference-faithful defaults
        args.aug_variants = 8 if args.benchmark == "cifar10sp" else 1
    tsp_aug_prob = (
        args.tsp_aug_prob
        if (args.benchmark == "tsp" and args.tsp_aug_prob > 0
            and args.aug_variants <= 1 and not args.test)
        else None
    )
    settings = BENCH_SETTINGS[args.benchmark]
    folds = [args.fold] if args.fold >= 0 else list(range(args.folds))
    results = []
    for fold in folds:
        print(f"Fold {fold} begin")
        eval_split = "val"
        if args.synthetic or args.data_root is None:
            samples = synthetic_samples(args, seed=fold)
            n_val = max(len(samples) // 10, 1)
            train_s, val_s = samples[n_val:], samples[:n_val]
        else:
            # npz cache / raw public formats (data/ingest.py); official
            # train/val splits when the files provide them
            from hl_hgat_tpu_torch.data.ingest import effective_aug_variants, load_samples

            kw = dict(
                root=args.data_root,
                keig=(args.keig or 15) + 1 if args.benchmark == "zinc"
                else (10 if args.benchmark == "cifar10sp" else 100),
                num_pool=1 if args.benchmark in ("pepfunc", "cifar10sp") else 0,
                seed=fold,
                aug_variants=args.aug_variants,
                limit=args.limit_samples or None,
            )
            if args.test:
                # evaluate the saved best checkpoint on the test split
                # (reference --test path, main_cifar10SP...py:196-199)
                try:
                    train_s = load_samples(args.benchmark, split="test", **kw)
                    eval_split = "test"
                except FileNotFoundError:
                    train_s = load_samples(args.benchmark, split="val", **kw)
                    eval_split = "val (no test split files found)"
                val_s = train_s
            else:
                train_s = load_samples(args.benchmark, split="train", **kw)
                a = effective_aug_variants(args.benchmark, "train", args.aug_variants)
                try:
                    val_s = load_samples(args.benchmark, split="val", **kw)
                except FileNotFoundError:
                    # hold out 10% of GROUPS; validate on the clean
                    # (variant-0) roll of each held-out graph
                    n_val = max(len(train_s) // a // 10, 1)
                    val_s = train_s[: n_val * a: a]
                    train_s = train_s[n_val * a:]
        first = train_s[0]
        model, meta = make_model(args, in_t=first.x_t.shape[1], in_s=first.x_s.shape[1],
                                 seed=fold, device=device)
        model = with_recipe(model, compute_dtype=args.dtype, stack_concat=args.stack_concat)
        cfg = TrainerConfig(
            task=settings["task"],
            lr=args.lr,
            weight_decay=args.l2,
            plateau_patience=settings["patience"],
            save_gate=settings["save_gate"],
            metric_mode=settings["metric_mode"],
            denorm=settings.get("denorm", 1.0),
            early_stop_lr=1e-5 if args.benchmark == "tsp" else None,
            ckpt_dir=os.path.join(args.save_dir, f"{args.benchmark}_fold{fold}"),
            ckpt_every=args.ckpt_every,
            seed=fold,
            pe_flip_node_static=(settings["pe_static"] or (None, None))[0],
            pe_flip_edge_static=(settings["pe_static"] or (None, None))[1],
            tsp_aug_prob=tsp_aug_prob,
        )
        trainer = _make_trainer(args, model, cfg, device)
        # dropout draws from torch's global stream: seeded with the fold, as
        # the JAX trainer seeds its training stream
        torch.manual_seed(fold)
        y_per_edge = settings["task"] == "edge_binary"
        y_per_node = settings["task"] == "node_classification"
        link_task = settings["task"] == "link_prediction"
        if y_per_node or link_task:
            # packed collators carry neither node labels nor flat-row pair
            # indices (the packer reorders node rows into superblocks)
            layout = "coo"
        else:
            layout = resolve_layout(args.layout, list(train_s) + list(val_s),
                                    args.pack_cap, args.edge_cap or args.pack_cap)
            if args.layout == "auto":
                print(f"--layout auto -> {layout}")

        def make_loader(ss, shuffle, **lkw):
            return BucketedLoader(
                ss, batch_size=args.batch_size, shuffle=shuffle, y_per_edge=y_per_edge,
                y_per_node=y_per_node, link_queries=(4, 8) if link_task else None,
                seed=fold, layout="dense_packed" if layout == "packed" else "coo",
                node_cap=args.pack_cap, edge_cap=args.edge_cap or args.pack_cap,
                transfer=args.transfer,
                # bf16 compute casts features at model entry anyway: ship
                # them pre-cast (bit-identical, half the feature bytes)
                feature_dtype=args.dtype, **lkw)

        if args.test:
            # exact metrics: no filler duplicates in the final short batch
            val_loader = make_loader(val_s, False, pad_final=False)
            start = trainer.maybe_restore(prefer="best")
            if start == 1:
                raise _no_checkpoint(cfg.ckpt_dir)
            loss, metric = trainer.evaluate(val_loader)
            print(f"Fold {fold} {eval_split} loss={loss:.4f} metric={metric:.4f} "
                  f"(epoch {start - 1} best)")
            results.append(dict(fold=fold, loss=loss, metric=metric, epoch=start - 1))
            continue
        if args.data_root is not None and not args.synthetic:
            from hl_hgat_tpu_torch.data.ingest import effective_aug_variants

            train_variants = effective_aug_variants(args.benchmark, "train",
                                                    args.aug_variants)
        else:
            train_variants = 1
        train_loader = make_loader(train_s, True, variants=train_variants)
        val_loader = make_loader(val_s, False)
        # each epoch's shuffle, variants and link queries follow the epoch
        # the trainer runs, so a resumed run sees what a straight one does
        trainer.fit(lambda: train_loader.set_epoch(trainer.epoch - 1),
                    lambda: val_loader.set_epoch(trainer.epoch - 1),
                    epochs=args.epochs, resume=bool(args.resume))
        print(f"Fold {fold} best metric: {trainer.best_metric:.4f}")
        results.append(dict(fold=fold, best_metric=trainer.best_metric,
                            history=trainer.history))
    return results


if __name__ == "__main__":
    main()
