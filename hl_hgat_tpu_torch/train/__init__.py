"""Training layer: losses, metrics, optimizer, plateau schedule, loop and
checkpoints (``hl_hgat_tpu/train``)."""

from hl_hgat_tpu_torch.train.losses import (
    bce_logits_loss,
    focal_loss,
    l1_loss,
    mse_loss,
    soft_dice_loss,
    softmax_ce_loss,
    weighted_mse_loss,
)
from hl_hgat_tpu_torch.train.metrics import (
    accuracy,
    average_precision,
    mae,
    pearson_corr,
    per_graph_binary_f1,
)
from hl_hgat_tpu_torch.train.optim import ReduceLROnPlateau, adam_l2, set_learning_rate
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "l1_loss",
    "mse_loss",
    "softmax_ce_loss",
    "bce_logits_loss",
    "focal_loss",
    "soft_dice_loss",
    "weighted_mse_loss",
    "mae",
    "accuracy",
    "per_graph_binary_f1",
    "average_precision",
    "pearson_corr",
    "adam_l2",
    "set_learning_rate",
    "ReduceLROnPlateau",
    "Trainer",
    "TrainerConfig",
]
