"""``hgat_attpool`` on both sides: the port's brain model, shared-skeleton
batches and trainer, and the plain reference, from the raw subject series of
``traffic/fmri.py`` on the Shen-268 skeleton."""

from __future__ import annotations

import functools

from portbench.reference import hgat_attpool as ref
from portbench.traffic import fmri, generate

REFERENCE = ref


class _Ready:
    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


def draw_train(cfg: dict, mix: dict, seed: int, workers: int):
    """The mix's distinct batches of (series [G, R, T], scores [G])."""
    d, g = cfg["data"], mix["batch_graphs"]
    series, scores = generate.subjects(seed, generate.TRAIN_STREAM,
                                       g * mix["distinct_batches"], d["rois"], d["t_len"])
    return _Ready([(series[i:i + g], scores[i:i + g]) for i in range(0, len(scores), g)])


def _sizes():
    skel = fmri.skeleton()
    return dict(nodes=int(skel["num_node"][-1]), edges=int(skel["num_edge"][-1]))


def param_spec(cfg: dict):
    return ref.param_spec(cfg["model"], _sizes())


def graphs(raw) -> int:
    return len(raw[1])


def shape(cfg: dict, raw) -> dict:
    return ref.shape_of(len(raw[1]), raw[0].shape[-1], fmri.skeleton(), cfg["model"]["pool_num"])


# -- the port --------------------------------------------------------------


def _program_pyramid(cfg: dict):
    return _pyramid(cfg["model"]["pool_num"], cfg["data"]["pyramid_seed"])


@functools.cache
def _pyramid(pool_num: int, seed: int):
    """The port's MLGC pyramid of the skeleton, built once a process."""
    from hl_hgat_tpu_torch.data.brain import brain_pyramid

    skel = fmri.skeleton()
    return brain_pyramid(skel["skeleton_src"], skel["skeleton_dst"], skel["skeleton_val"],
                         pool_num=pool_num, seed=seed)


def program_model(cfg: dict, state: dict, device):
    from hl_hgat_tpu_torch.models import presets
    levels, _ = _program_pyramid(cfg)
    m = cfg["model"]
    model, _ = presets.hgat_attpool(
        channels=m["channels"], filters=m["filters"], k=m["k"], mlp_channels=m["mlp_channels"],
        pool_num=m["pool_num"], nodes_per_graph=levels[-1].num_nodes,
        edges_per_graph=levels[-1].num_edges, fine_nodes_per_graph=levels[0].num_nodes,
        fine_edges_per_graph=levels[0].num_edges, compute_dtype=cfg["dtype"], device=device)
    model.load_state_dict(state, strict=True)
    return model


def program_trainer(cfg: dict, model, device):
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    t = cfg["trainer"]
    return Trainer(model, TrainerConfig(task=t["task"], lr=t["lr"],
                                        weight_decay=t["weight_decay"], metric_mode="max"),
                   device=device)


def program_batch(cfg: dict, raw):
    """The port's shared-skeleton batch on the host."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
    from hl_hgat_tpu_torch.data.datasets import brain_sample

    levels, pools = _program_pyramid(cfg)
    series, scores = raw
    return collate_dense_shared([
        brain_sample(ts, levels[0].src, levels[0].dst, levels, pools, y=float(y),
                     y_mean=ref.Y_MEAN, y_std=ref.Y_STD)
        for ts, y in zip(series, scores)])


# -- the reference ---------------------------------------------------------


def reference_loss(cfg: dict, device, prec):
    m = cfg["model"]
    skel = fmri.skeleton()
    pyr = ref.pyramid(skel, device, m["pool_num"], m["deg_eps"])

    def loss_of(p, raw):
        batch = ref.make_batch(raw[0], raw[1], skel, device, prec.dtype)
        pred, _, _ = ref.forward(p, batch, pyr, m, train=True, prec=prec)
        return ref.loss(pred, batch["y"])
    return loss_of
