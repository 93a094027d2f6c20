"""Metrics (``hl_hgat_tpu/train/metrics.py``): denormalized MAE (ZINC),
accuracy (CIFAR10-SP), per-graph BinaryF1 (TSP, reference
main_TSP...py:344-352), macro Average Precision (Peptides, reference
lib/Hodge_Dataset.py:73-94), macro F1, MRR, Pearson correlation (brain
demo).  Tensor functions return 0-d tensors on the inputs' device; the
ranking metrics work on numpy arrays on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def mae(pred: torch.Tensor, target: torch.Tensor, *, denorm: float = 1.0) -> torch.Tensor:
    """Mean absolute error, optionally rescaled to raw label units
    (ZINC: × 2.0109, reference main_zinc...py:177)."""
    return (pred.reshape(-1) - target.reshape(-1)).abs().mean() * denorm


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels.long()).float().mean()


def per_graph_binary_f1(
    logits: torch.Tensor,
    targets: torch.Tensor,
    seg_id: torch.Tensor,
    num_graphs: int,
    mask: torch.Tensor | None = None,
    *,
    threshold_logit: float = 0.0,
) -> torch.Tensor:
    """Mean over graphs of the binary F1 of thresholded per-edge logits
    (sigmoid + 0.5 on logits is a threshold at 0; reference
    main_TSP...py:344-352 computes F1 per graph, then averages).  Ids at or
    beyond ``num_graphs`` are dropped."""
    pred = (logits.reshape(-1) > threshold_logit).float()
    t = targets.reshape(-1).float()
    m = torch.ones_like(pred) if mask is None else mask.reshape(-1).float()
    seg = seg_id.reshape(-1).long()
    m = m * (seg < num_graphs)
    seg = seg.clamp(max=num_graphs - 1)

    def seg_sum(v):
        return torch.zeros(num_graphs, device=v.device).index_add_(0, seg, v)

    tp = seg_sum(pred * t * m)
    fp = seg_sum(pred * (1 - t) * m)
    fn = seg_sum((1 - pred) * t * m)
    return (2 * tp / (2 * tp + fp + fn).clamp(min=1e-12)).mean()


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn-compatible AP for one task: sum_n (R_n − R_{n−1}) · P_n."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(-y_score, kind="stable")
    yt = y_true[order]
    tp = np.cumsum(yt)
    fp = np.cumsum(1 - yt)
    precision = tp / np.maximum(tp + fp, 1e-12)
    n_pos = yt.sum()
    if n_pos == 0:
        return 0.0
    recall = tp / n_pos
    # collapse ties on score: keep the last entry of each tie block
    distinct = np.nonzero(np.diff(y_score[order]))[0]
    idx = np.r_[distinct, yt.size - 1]
    precision, recall = precision[idx], recall[idx]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def eval_ap(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro AP over tasks, skipping tasks without both classes
    (reference ``eval_ap``, lib/Hodge_Dataset.py:73-94)."""
    aps = []
    for i in range(y_true.shape[1]):
        col = y_true[:, i]
        if (col == 1).any() and (col == 0).any():
            labeled = col == col  # drop NaNs
            aps.append(average_precision(col[labeled], y_pred[labeled, i]))
    if not aps:
        raise RuntimeError("no positively labeled task")
    return float(np.mean(aps))


def macro_f1(
    logits: np.ndarray, labels: np.ndarray, num_classes: int,
    mask: np.ndarray | None = None,
) -> float:
    """Macro-averaged multiclass F1 over the classes present in prediction
    or truth (sklearn's default macro averaging over present labels)."""
    pred = np.argmax(np.asarray(logits), axis=-1).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    if mask is not None:
        keep = np.asarray(mask).reshape(-1) > 0
        pred, labels = pred[keep], labels[keep]
    f1s = []
    for c in range(num_classes):
        tp = float(np.sum((pred == c) & (labels == c)))
        fp = float(np.sum((pred == c) & (labels != c)))
        fn = float(np.sum((pred != c) & (labels == c)))
        if tp + fp + fn == 0:
            continue
        f1s.append(2 * tp / max(2 * tp + fp + fn, 1e-12))
    return float(np.mean(f1s)) if f1s else 0.0


def mrr(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """Mean reciprocal rank: ``pos_scores`` [Q], ``neg_scores`` [Q, K];
    optimistic ties (rank = 1 + #negatives strictly greater)."""
    pos = np.asarray(pos_scores).reshape(-1, 1)
    neg = np.asarray(neg_scores).reshape(pos.shape[0], -1)
    rank = 1.0 + np.sum(neg > pos, axis=1)
    return float(np.mean(1.0 / rank))


def pearson_corr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = pred.reshape(-1) - pred.mean()
    t = target.reshape(-1) - target.mean()
    return (p * t).sum() / (p.norm() * t.norm()).clamp(min=1e-12)
