"""The training loop (``hl_hgat_tpu/train/trainer.py``).

    model, meta = presets.zinc_pyr()                   # on the CUDA card
    trainer = Trainer(model, TrainerConfig(task=meta["task"], denorm=meta["y_std"]))
    trainer.fit(train_batches, val_batches, epochs=100)

One eager ``train_step`` / ``eval_step`` pair per model.  Semantics kept
from the JAX trainer: Adam + torch-style L2, ReduceLROnPlateau on the
validation loss, ``on_improve`` only when the validation metric beats gate
+ best (reference main_zinc...py:241-248), optional early stop when the lr
decays below a floor (reference main_TSP...py:421-422).  The model and the
optimizer hold the training state, so the steps take a batch and nothing
else.

A batch is a packed `DenseBatch` (graphs over one block span blocks), a
`CompactBatch` (``complex/compact.py``), which the steps densify on the
trainer's device right after the transfer, or a flat `ComplexBatch`; the
``node_classification`` and ``link_prediction`` tasks read the flat batch's
node mask, pairs and pair mask, and the ``edge_binary`` task (the TSP
model) per-edge labels on either layout.  ``fit`` collates the next
``prefetch`` batches on a background thread (``data/prefetch.py``).

Checkpoints (``train/checkpoint.py``) as in the JAX trainer: with
``ckpt_dir`` the full state is saved there whenever the validation metric
improves, and with ``ckpt_every`` N also to ``<ckpt_dir>/latest`` every N
epochs; ``maybe_restore`` picks the newer of the two (``prefer="best"``:
the improvement checkpoint only) and ``fit(resume=True)`` continues from
it.  A resume restores what the JAX trainer restores: parameters, BN
statistics, the Adam state, the random streams, the best metric and the
plateau's lr from ``meta.json``; the plateau's ``best`` and ``num_bad`` are
not saved (nor are they in the JAX package), so a resumed plateau counts
afresh.

The JAX ``prng_impl`` field selects a JAX random generator and has no
counterpart: ``Trainer.generator``, on the trainer's device and seeded
with ``config.seed``, is the one source of the step's random draws (the PE
sign flips, then ``tsp_aug_prob``, in the JAX trainer's order); dropout
draws from torch's global stream.  Both are saved in a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.augment import pe_sign_flip, tsp_dropout
from hl_hgat_tpu_torch.complex.batch import ComplexLevel
from hl_hgat_tpu_torch.complex.compact import maybe_inflate
from hl_hgat_tpu_torch.complex.dense import Batch
from hl_hgat_tpu_torch.data.prefetch import prefetch
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.train import losses as L
from hl_hgat_tpu_torch.train import metrics as M
from hl_hgat_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from hl_hgat_tpu_torch.train.optim import ReduceLROnPlateau, adam_l2, set_learning_rate


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    # regression|classification|multilabel|edge_binary|brain|
    # node_classification|link_prediction
    task: str = "regression"
    lr: float = 1e-3
    weight_decay: float = 1e-3
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    min_lr: float = 1e-6
    early_stop_lr: float | None = None
    save_gate: float | None = None  # metric floor/ceiling for on_improve
    metric_mode: str = "min"  # 'min' (MAE) or 'max' (acc/F1/AP)
    denorm: float = 1.0  # MAE denormalization (ZINC: 2.0109)
    log_path: str | None = None
    seed: int = 0
    # eigen-PE sign flips inside train_step (complex/augment.py): the number
    # of leading static (non-PE) feature columns of x_t / x_s; None: off
    pe_flip_node_static: int | None = None
    pe_flip_edge_static: int | None = None
    # TSP structure augmentation inside train_step (complex/augment.py),
    # applied to each graph with this probability; None: off
    tsp_aug_prob: float | None = None
    # batches fit collates ahead on a background thread (data/prefetch.py); 0: off
    prefetch: int = 2
    # the full state is saved here when the validation metric improves
    # (train/checkpoint.py); None: no checkpoints
    ckpt_dir: str | None = None
    # also save it every N epochs to <ckpt_dir>/latest, improved or not, so
    # a crashed run resumes from its last epoch; 0: off
    ckpt_every: int = 0


def _loss_for(task: str):
    if task == "regression":
        return lambda out, batch: L.l1_loss(out.reshape(-1), batch.y.reshape(-1))
    if task == "brain":
        # the OHBM training loop's criterion: MSELoss on z-scored scores
        # (reference HL-HGAT-DEMO/OHBM_DEMO.ipynb cell 40)
        return lambda out, batch: L.mse_loss(out.reshape(-1), batch.y.reshape(-1))
    if task == "classification":
        return lambda out, batch: L.softmax_ce_loss(out, batch.y.reshape(-1).long())
    if task == "multilabel":
        return lambda out, batch: L.focal_loss(out, batch.y)
    if task == "edge_binary":
        # per-edge labels; the flattened mask drops padded edge rows
        return lambda out, batch: L.focal_loss(
            out.reshape(-1), batch.y.reshape(-1), batch.level0.edge_mask.reshape(-1))
    if task == "node_classification":
        # per-node CE masked by node validity
        return lambda out, batch: L.softmax_ce_loss(
            out.reshape(-1, out.shape[-1]), batch.y.reshape(-1).long(),
            batch.level0.node_mask.reshape(-1))
    if task == "link_prediction":
        # per-pair BCE over the batch-carried queries
        return lambda out, batch: L.bce_logits_loss(
            out.reshape(-1), batch.y.reshape(-1), batch.pair_mask)
    raise ValueError(f"unknown task {task!r}")


def _mean_of(total: torch.Tensor | None, n: int) -> float:
    """The one readback of an epoch's device-side sum."""
    return float(total) / max(n, 1) if total is not None else 0.0


class Trainer:
    """Owns the model, the optimizer, the plateau scheduler and the
    improvement gate.  Runs on the CUDA card unless ``device`` says
    otherwise; without a card and without ``device="cpu"`` it raises."""

    def __init__(self, model: torch.nn.Module, config: TrainerConfig, device=None):
        self.cfg = config
        self._loss_fn = _loss_for(config.task)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = adam_l2(self.model.parameters(), config.lr, config.weight_decay)
        self.plateau = ReduceLROnPlateau(
            lr=config.lr,
            patience=config.plateau_patience,
            factor=config.plateau_factor,
            min_lr=config.min_lr,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.best_metric = np.inf if config.metric_mode == "min" else -np.inf
        self.history: list[dict] = []
        # the epoch fit is running (1-based), for loaders positioned by epoch
        self.epoch = 0

    # -- state ---------------------------------------------------------------

    def maybe_restore(self, prefer: str = "newest") -> int:
        """Load a checkpoint from ``ckpt_dir`` if there is one; returns the
        epoch to start from (1 when nothing was loaded).

        ``prefer="newest"`` (resume) takes whichever of the improvement
        checkpoint and ``latest/`` has the higher ``meta.json`` epoch and
        needs the full state; ``prefer="best"`` (test, serving) takes the
        improvement checkpoint only, and a file holding the model alone
        will do.  The best metric and the plateau's lr come from
        ``meta.json``."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return 1
        if prefer not in ("newest", "best"):
            raise ValueError(f"prefer must be 'newest' or 'best', got {prefer!r}")
        dirs = (cfg.ckpt_dir,) if prefer == "best" else (
            cfg.ckpt_dir, os.path.join(cfg.ckpt_dir, "latest"))
        candidates = [d for d in dirs if has_checkpoint(d)]
        if not candidates:
            return 1
        chosen = max(candidates, key=lambda d: int(load_metadata(d).get("epoch", 0)))
        restore_checkpoint(chosen, self, full=prefer != "best")
        meta = load_metadata(chosen)
        if "best_metric" in meta:
            self.best_metric = meta["best_metric"]
        elif "metric" in meta:
            self.best_metric = meta["metric"]
        if "lr" in meta:
            self.plateau.lr = meta["lr"]
            set_learning_rate(self.optimizer, meta["lr"])
        return int(meta.get("epoch", 0)) + 1

    # -- steps ---------------------------------------------------------------

    def _on_device(self, batch):
        """The batch's tensors on the trainer's device, a compact batch
        densified there."""
        return maybe_inflate(batch.to(self.device))

    def _forward_loss(self, batch: Batch):
        out = self.model(batch)
        if isinstance(out, tuple):
            out = out[0]
        return out, self._loss_fn(out, batch)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """Forward (BN on batch statistics), loss, backward, one Adam
        update.  Returns the loss as a 0-d tensor on the device — no
        readback, so the host can run ahead of the card."""
        batch = self._on_device(batch)
        cfg = self.cfg
        if cfg.pe_flip_node_static is not None:
            batch = batch.replace(x_t=pe_sign_flip(
                batch.x_t, num_static=cfg.pe_flip_node_static, generator=self.generator))
        if cfg.pe_flip_edge_static is not None:
            batch = batch.replace(x_s=pe_sign_flip(
                batch.x_s, num_static=cfg.pe_flip_edge_static, generator=self.generator))
        if cfg.tsp_aug_prob is not None:
            batch = tsp_dropout(batch, apply_prob=cfg.tsp_aug_prob, generator=self.generator)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        _, loss = self._forward_loss(batch)
        loss.backward()
        # A parameter the loss does not reach (the link model's last edge
        # conv) gets a zero gradient, not none: the L2 term still decays it,
        # as in the JAX trainer, where every leaf has a gradient.
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        """(output, loss) in eval mode (BN on running statistics)."""
        return self._eval_forward(self._on_device(batch))

    def _eval_forward(self, batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        """`eval_step` on a batch already on the device and inflated."""
        self.model.eval()
        with torch.inference_mode():
            return self._forward_loss(batch)

    def train_epoch(self, batches: Iterable[Batch]) -> float:
        # The loss stays on the device until the epoch ends: a per-step
        # float() would make every step wait for the card.
        total, n = None, 0
        for batch in batches:
            contrib = self.train_step(batch) * batch.num_graphs
            total = contrib if total is None else total + contrib
            n += batch.num_graphs
        return _mean_of(total, n)

    def evaluate(self, batches: Iterable[Batch]) -> tuple[float, float]:
        """(mean loss, task metric) over ``batches``; everything stays on
        the device until the loop ends."""
        cfg = self.cfg
        total, n = None, 0
        preds, ys, accs, masks, f1s = [], [], [], [], []
        for batch in batches:
            batch = self._on_device(batch)  # the metrics read its labels and ids
            out, loss = self._eval_forward(batch)
            g = batch.num_graphs
            contrib = loss * g
            total = contrib if total is None else total + contrib
            n += g
            if cfg.task == "edge_binary":
                # per-graph F1 by each edge row's graph id (dump id on padding)
                lvl = batch.level0
                seg = lvl.s_id if isinstance(lvl, ComplexLevel) else lvl.s_gid
                f1s.append(M.per_graph_binary_f1(out, batch.y, seg, g, lvl.edge_mask) * g)
            elif cfg.task == "classification":
                accs.append(M.accuracy(out, batch.y.reshape(-1)) * g)
            elif cfg.task == "node_classification":
                preds.append(out.reshape(-1, out.shape[-1]))
                ys.append(batch.y.reshape(-1))
                masks.append(batch.level0.node_mask.reshape(-1))
            elif cfg.task == "link_prediction":
                preds.append(out.reshape(-1))
                ys.append(batch.y.reshape(-1))
                masks.append(batch.pair_mask.reshape(-1))
            else:
                preds.append(out.reshape(-1, out.shape[-1]))
                ys.append(batch.y.reshape(-1, out.shape[-1]))
        loss_avg = _mean_of(total, n)
        if cfg.task == "classification":
            return loss_avg, _mean_of(sum(accs) if accs else None, n)
        if cfg.task == "edge_binary":
            return loss_avg, _mean_of(sum(f1s) if f1s else None, n)
        p, y = torch.cat(preds), torch.cat(ys)
        if cfg.task == "node_classification":
            # macro F1 over valid nodes
            return loss_avg, M.macro_f1(
                p.float().cpu().numpy(), y.cpu().numpy(), num_classes=p.shape[-1],
                mask=torch.cat(masks).cpu().numpy())
        if cfg.task == "link_prediction":
            # groups are (one positive first, then its negatives) in
            # contiguous rows (attach_link_pairs): MRR is a reshape
            keep = torch.cat(masks).cpu().numpy() > 0
            p, y = p.float().cpu().numpy()[keep], y.cpu().numpy()[keep]
            q = int(y.sum())
            group = len(y) // max(q, 1)
            scores = p[: q * group].reshape(q, group)
            return loss_avg, M.mrr(scores[:, 0], scores[:, 1:])
        if cfg.task == "regression":
            metric = float(M.mae(p, y, denorm=cfg.denorm))
        elif cfg.task == "brain":
            # the notebook's test metric: Pearson correlation of the
            # normalized predictions vs scores (OHBM_DEMO.ipynb cell 42)
            metric = float(M.pearson_corr(p, y))
        else:  # multilabel
            metric = M.eval_ap(y.float().cpu().numpy(), p.float().cpu().numpy())
        return loss_avg, metric

    # -- fit -----------------------------------------------------------------

    def _improved(self, metric: float) -> bool:
        cfg = self.cfg
        if cfg.metric_mode == "min":
            gated = cfg.save_gate is None or metric < cfg.save_gate
            return gated and metric < self.best_metric
        gated = cfg.save_gate is None or metric > cfg.save_gate
        return gated and metric > self.best_metric

    def fit(
        self,
        train_batches: Callable[[], Iterable[Batch]],
        val_batches: Callable[[], Iterable[Batch]],
        *,
        epochs: int,
        on_improve: Callable[["Trainer", float], None] | None = None,
        verbose: bool = True,
        resume: bool = False,
    ) -> "Trainer":
        """``epochs`` rounds of train_epoch → evaluate → plateau step, each
        iterable collated ``config.prefetch`` batches ahead on a background
        thread.  ``on_improve(trainer, metric)`` runs when the validation
        metric passes the gate and beats the best so far, and with
        ``ckpt_dir`` the state is saved then.  ``resume=True`` first loads
        the newest checkpoint (``maybe_restore``) and continues after its
        epoch; ``self.epoch`` holds the epoch running, so a loader can be
        positioned by it."""
        cfg = self.cfg
        start = time.time()
        start_epoch = 1
        if resume:
            start_epoch = self.maybe_restore()
            if verbose and start_epoch > 1:
                print(f"resumed from epoch {start_epoch - 1}")
        for epoch in range(start_epoch, epochs + 1):
            self.epoch = epoch
            train_loss = self.train_epoch(prefetch(train_batches(), cfg.prefetch))
            val_loss, val_metric = self.evaluate(prefetch(val_batches(), cfg.prefetch))
            lr = self.plateau.step(val_loss)
            set_learning_rate(self.optimizer, lr)
            improved = self._improved(val_metric)
            if improved:
                self.best_metric = val_metric
                if on_improve is not None:
                    on_improve(self, val_metric)
                if cfg.ckpt_dir:
                    save_checkpoint(cfg.ckpt_dir, self,
                                    extra=dict(epoch=epoch, metric=val_metric, lr=lr))
            if cfg.ckpt_every and cfg.ckpt_dir and epoch % cfg.ckpt_every == 0:
                save_checkpoint(os.path.join(cfg.ckpt_dir, "latest"), self, extra=dict(
                    epoch=epoch, metric=val_metric, lr=lr, best_metric=self.best_metric))
            rec = dict(
                epoch=epoch, time=time.time() - start, train_loss=train_loss,
                val_loss=val_loss, val_metric=val_metric, lr=lr,
                improved=improved,
            )
            self.history.append(rec)
            if verbose:
                print(
                    f"Epoch {epoch:03d} t={rec['time']:.1f}s "
                    f"train={train_loss:.4f} val={val_loss:.4f} "
                    f"metric={val_metric:.4f} lr={lr:.2e}"
                    + ((" *saved*" if cfg.ckpt_dir else " *improved*") if improved else "")
                )
            if cfg.log_path:
                with open(cfg.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if cfg.early_stop_lr is not None and lr < cfg.early_stop_lr:
                break
        return self
