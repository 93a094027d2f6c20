"""Brain fMRI demo on the card: the OHBM notebook's flow end to end
(``examples/brain_demo.py`` of the JAX package, the same flags, stages and
printed lines).

1. **init**: group FC → skeleton (``fc2mask`` on synthetic series; the
   study's shipped mask with ``--real``) → shared simplex complex → two
   ``MLGC_Weight`` coarsenings (single-fine-edge pruning, isolated nodes
   dropped) → one sample a subject on the shared pyramid;
2. **train**: ``hgat_attpool`` (Inception1D time embedding, attention
   pooling, flatten readout) on ``collate_dense_shared`` batches, MSE on
   the z-scored scores, Adam at lr 1e-3 (optax's defaults);
3. **evaluate**: Pearson r and RMSE on the validation quarter;
4. **analyze**: the subjects' mean edge attention as a symmetric ROI × ROI
   matrix, sorted by parcel (the real lobes with ``--real``).

``--real auto`` takes the reference's group data (``Group_FC.mat``,
``Group_FCMask.mat``, ``affiliations.mat``) when ``$HLHGAT_BRAIN_DIR``
names a directory (``data.brain.REFERENCE_BRAIN_DIR``) and no ``--data``
is given; the
per-subject series are synthetic unless ``--data`` names an npz with
``timeseries`` and ``scores``.  Every conv on the shared layout runs the
Laguerre terms kernel on the folded features (``nn.conv.folded_terms``).
Runs on the card; ``--cpu`` runs it on the CPU::

    python -m hl_hgat_tpu_torch.examples.brain_demo --real off --rois 268
    python -m hl_hgat_tpu_torch.examples.brain_demo --real off --rois 16 --cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample, GraphStructure, build_structure
from hl_hgat_tpu_torch.complex.coarsen import mlgc
from hl_hgat_tpu_torch.complex.dense import DenseBatch, collate_dense_shared
from hl_hgat_tpu_torch.data import brain as brain_data
from hl_hgat_tpu_torch.data.datasets import brain_sample, fc2mask
from hl_hgat_tpu_torch.data.synthetic import synthetic_fmri_series
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.train.losses import mse_loss
from hl_hgat_tpu_torch.train.metrics import pearson_corr
from hl_hgat_tpu_torch.train.optim import adam_l2
from hl_hgat_tpu_torch.utils.profiling import StepTimer, device_barrier
from hl_hgat_tpu_torch.utils.viz import attention_fc_matrix, sort_by_parcels

# the demo's model: hgat_attpool cut to the notebook's widths
MODEL = dict(channels=(1, 1, 1), filters=(16, 16, 32), k=3, pool_num=2, mlp_channels=(32,))
LR = 1e-3


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", type=int, default=24)
    ap.add_argument("--rois", type=int, default=32)
    ap.add_argument("--t", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--mask_percent", type=float, default=0.2)
    ap.add_argument("--data", default=None, help="npz with timeseries/scores")
    ap.add_argument(
        "--real", default="auto", choices=["auto", "on", "off"],
        help="use the reference's real Group_FC/FCMask/affiliations "
             "from $HLHGAT_BRAIN_DIR (auto: when it names a directory)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap


@dataclasses.dataclass
class DemoInit:
    """What the init stage builds: the skeleton, the shared pyramid, one
    sample a subject split into train and validation, and the generator
    whose later draws give the synthetic parcels."""

    src: np.ndarray
    dst: np.ndarray
    rois: int
    use_real: bool
    levels: list[GraphStructure]
    pools: list[tuple[np.ndarray, np.ndarray]]
    train: list[GraphSample]
    val: list[GraphSample]
    rng: np.random.Generator


def init_stage(args: argparse.Namespace, log=print) -> DemoInit:
    """Skeleton, pyramid and samples, with the JAX demo's draws from one
    ``default_rng(0)``."""
    use_real = args.real == "on" or (
        args.real == "auto" and brain_data.reference_data_available() and args.data is None)
    rng = np.random.default_rng(0)
    rois = args.rois
    if use_real:
        levels, pools, _ = brain_data.build_real_brain_pyramid(pool_num=2)
        src, dst = levels[0].src, levels[0].dst
        rois = levels[0].num_nodes
        log(f"REAL skeleton: {rois} ROIs, {src.size} edges "
            f"(level-1 n+e = {levels[1].num_nodes + levels[1].num_edges})")
    if args.data:
        z = np.load(args.data)
        ts_all, scores = z["timeseries"], z["scores"]
    else:
        ts_all, scores = synthetic_fmri_series(rng, args.subjects, rois, args.t)

    if not use_real:
        fcs = np.stack([np.corrcoef(ts) for ts in ts_all])
        mask = fc2mask(fcs, percent=args.mask_percent, mode=1)
        src, dst = np.nonzero(mask)
        order = np.argsort(src * mask.shape[0] + dst)
        src, dst = src[order].astype(np.int32), dst[order].astype(np.int32)
        log(f"skeleton: {rois} ROIs, {src.size} edges")
        levels = [build_structure(src, dst, rois)]
        pools = []
        weight = np.abs(fcs.mean(0))[src, dst]
        for lvl in range(2):
            step = mlgc(levels[-1], edge_weight=weight, prune_single_fine_edges=True,
                        drop_isolated_nodes=True)
            levels.append(step.structure)
            pools.append((step.c_node, step.c_edge))
            weight = None
            log(f"  pool {lvl}: {step.structure.num_nodes} nodes / "
                f"{step.structure.num_edges} edges")

    samples = [brain_sample(ts_all[s], src, dst, levels, pools, y=scores[s], rng=rng)
               for s in range(args.subjects)]
    n_val = max(args.subjects // 4, 1)
    return DemoInit(src=src, dst=dst, rois=rois, use_real=use_real, levels=levels, pools=pools,
                    train=samples[n_val:], val=samples[:n_val], rng=rng)


def batches(split: list[GraphSample], batch_size: int, device) -> list[DenseBatch]:
    """The split in order, ``batch_size`` subjects a batch (clamped to the
    split's size; a short tail is dropped), collated with the shared
    operators and moved to ``device``."""
    bs = min(batch_size, len(split))
    return [collate_dense_shared(split[i:i + bs]).to(device)
            for i in range(0, len(split) - bs + 1, bs)]


def build_model(init: DemoInit, device, *, seed: int = 0):
    """The demo's ``hgat_attpool`` on the pyramid's sizes, seeded; (model,
    meta) as ``presets.hgat_attpool`` gives them."""
    final, fine = init.levels[-1], init.levels[0]
    return presets.hgat_attpool(
        **MODEL, nodes_per_graph=final.num_nodes, edges_per_graph=final.num_edges,
        fine_nodes_per_graph=fine.num_nodes, fine_edges_per_graph=fine.num_edges,
        seed=seed, device=device)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: DenseBatch) -> torch.Tensor:
    """One MSE step with BN on batch statistics; the loss as a 0-d tensor
    on the batch's device."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    pred = model(batch)[0]
    loss = mse_loss(pred.reshape(-1), batch.y.reshape(-1))
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_stage(model: torch.nn.Module, train: list[DenseBatch], epochs: int,
                log=print, timer: StepTimer | None = None) -> list[float]:
    """``epochs`` passes over the train batches with Adam at ``LR``; the
    mean loss of each epoch.  With ``timer`` every step is timed up to the
    end of its work on the device."""
    optimizer = adam_l2(model.parameters(), lr=LR)
    epoch_losses = []
    for epoch in range(epochs):
        losses = []
        for batch in train:
            if timer is None:
                losses.append(train_step(model, optimizer, batch))
                continue
            with timer:
                losses.append(train_step(model, optimizer, batch))
                device_barrier(losses[-1])
        epoch_losses.append(float(np.mean(torch.stack(losses).cpu().numpy())))
        log(f"epoch {epoch}: train MSE {epoch_losses[-1]:.4f}")
    return epoch_losses


@torch.no_grad()
def evaluate_stage(model: torch.nn.Module, val: list[DenseBatch], meta: dict, log=print) -> dict:
    """Predictions, targets and edge attention of the validation batches
    (BN on running statistics), with Pearson r and the RMSE in raw score
    units."""
    model.eval()
    preds, ys, edge_atts = [], [], []
    for batch in val:
        pred, _, _, edge_att = model(batch)
        preds.append(pred.reshape(-1).float())
        ys.append(batch.y.reshape(-1).float())
        edge_atts.append(edge_att.float())
    pred, y = torch.cat(preds), torch.cat(ys)
    corr = float(pearson_corr(pred, y))
    rmse = float(torch.sqrt(torch.mean((pred - y) ** 2))) * meta["y_std"]
    log(f"validation: corr {corr:.3f}, RMSE {rmse:.3f} (raw score units)")
    return dict(pred=pred.cpu().numpy(), y=y.cpu().numpy(),
                edge_att=torch.cat(edge_atts).cpu().numpy(), corr=corr, rmse=rmse)


def analyze_stage(init: DemoInit, edge_att: np.ndarray, log=print) -> dict:
    """The subjects' mean edge attention as an ROI × ROI matrix, sorted by
    the real lobes or by synthetic parcels (the init generator's next
    draws)."""
    fc_att = attention_fc_matrix(edge_att.mean(0), init.src, init.dst, init.rois)
    top = np.unravel_index(np.argmax(fc_att), fc_att.shape)
    if init.use_real:
        aff = brain_data.load_affiliations()
        out = brain_data.lobe_sorted_matrix(fc_att, aff["affiliation"], aff["lobe_names"])
        log(f"attention FC matrix {fc_att.shape}, lobe-sorted with the real affiliations; "
            "blocks: " + ", ".join(f"{n}={s}" for n, s in zip(out["labels"][:4], out["sizes"][:4]))
            + f", ...; top-attention edge: {top}")
        return dict(fc_att=fc_att, sorted=out["matrix"], perm=out["perm"], top=top)
    parcels = init.rng.integers(0, 4, init.rois)  # synthetic lobe labels
    sorted_m, perm, bounds = sort_by_parcels(fc_att, parcels)
    log(f"attention FC matrix {fc_att.shape}, parcel boundaries at {bounds.tolist()}; "
        f"top-attention edge: {top}")
    return dict(fc_att=fc_att, sorted=sorted_m, perm=perm, bounds=bounds, top=top)


def main(argv=None) -> dict:
    """The whole demo; returns the stages' results."""
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    init = init_stage(args)
    train = batches(init.train, args.batch_size, device)
    val = batches(init.val, args.batch_size, device)
    model, meta = build_model(init, device)
    losses = train_stage(model, train, args.epochs)
    result = evaluate_stage(model, val, meta)
    return dict(init=init, losses=losses, eval=result,
                analysis=analyze_stage(init, result["edge_att"]))


if __name__ == "__main__":
    main()
