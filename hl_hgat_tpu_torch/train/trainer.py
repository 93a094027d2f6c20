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

A batch is a packed `DenseBatch` (graphs over one block span blocks) or a
flat `ComplexBatch`; the ``node_classification`` and ``link_prediction``
tasks read the flat batch's node mask, pairs and pair mask, and the
``edge_binary`` task (the TSP model) per-edge labels on either layout.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: checkpoints (``ckpt_dir``, ``ckpt_every``, ``resume``), the
positional-encoding sign flips (``pe_flip_*``) and ``prefetch > 0`` — see
ROADMAP.md, Queue 1.  The JAX ``prng_impl`` field selects a JAX random
generator and has no counterpart: ``Trainer.generator``, on the trainer's
device and seeded with ``config.seed``, is the one source of the step's
random draws (``tsp_aug_prob``); dropout draws from torch's global stream.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Iterable

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.augment import tsp_dropout
from hl_hgat_tpu_torch.complex.batch import ComplexLevel
from hl_hgat_tpu_torch.complex.dense import Batch
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.train import losses as L
from hl_hgat_tpu_torch.train import metrics as M
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
    # TSP structure augmentation inside train_step (complex/augment.py),
    # applied to each graph with this probability; None: off
    tsp_aug_prob: float | None = None
    # fields of the JAX config whose feature is not ported: any value but
    # the "off" default below raises NotImplementedError
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    pe_flip_node_static: int | None = None
    pe_flip_edge_static: int | None = None
    prefetch: int = 0  # the JAX default is 2; this package has no prefetcher


_QUEUED_OPTIONS = {
    "ckpt_dir": "Queue 1 item 12 (checkpoint and CLI)",
    "ckpt_every": "Queue 1 item 12 (checkpoint and CLI)",
    "pe_flip_node_static": "Queue 1 item 11 (data pipeline and augmentation)",
    "pe_flip_edge_static": "Queue 1 item 11 (data pipeline and augmentation)",
    "prefetch": "Queue 1 item 11 (data pipeline and augmentation)",
}


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
        defaults = TrainerConfig()
        for name, where in _QUEUED_OPTIONS.items():
            if getattr(config, name) != getattr(defaults, name):
                raise NotImplementedError(
                    f"TrainerConfig.{name} waits for ROADMAP.md {where}")
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

    # -- steps ---------------------------------------------------------------

    def _forward_loss(self, batch: Batch):
        out = self.model(batch)
        if isinstance(out, tuple):
            out = out[0]
        return out, self._loss_fn(out, batch)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """Forward (BN on batch statistics), loss, backward, one Adam
        update.  Returns the loss as a 0-d tensor on the device — no
        readback, so the host can run ahead of the card."""
        batch = batch.to(self.device)
        if self.cfg.tsp_aug_prob is not None:
            batch = tsp_dropout(batch, apply_prob=self.cfg.tsp_aug_prob,
                                generator=self.generator)
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
        batch = batch.to(self.device)
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
            batch = batch.to(self.device)
            out, loss = self.eval_step(batch)
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
        """``epochs`` rounds of train_epoch → evaluate → plateau step.
        ``on_improve(trainer, metric)`` runs when the validation metric
        passes the gate and beats the best so far."""
        if resume:
            raise NotImplementedError(
                "resume waits for ROADMAP.md Queue 1 item 12 (checkpoint and CLI)")
        cfg = self.cfg
        start = time.time()
        for epoch in range(1, epochs + 1):
            train_loss = self.train_epoch(train_batches())
            val_loss, val_metric = self.evaluate(val_batches())
            lr = self.plateau.step(val_loss)
            set_learning_rate(self.optimizer, lr)
            improved = self._improved(val_metric)
            if improved:
                self.best_metric = val_metric
                if on_improve is not None:
                    on_improve(self, val_metric)
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
                    + (" *improved*" if improved else "")
                )
            if cfg.log_path:
                with open(cfg.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if cfg.early_stop_lr is not None and lr < cfg.early_stop_lr:
                break
        return self
