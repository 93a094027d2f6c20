"""``zinc_pyr`` on both sides: the port's model, batches and predictor, and
the plain reference, from the raw molecules of ``traffic/zinc_like.py``."""

from __future__ import annotations

import numpy as np

from portbench.reference import zinc_pyr as ref
from portbench.traffic import generate

REFERENCE = ref


def draw_train(cfg: dict, mix: dict, seed: int, workers: int):
    """The mix's distinct training batches, drawn in the background."""
    chunks = [mix["batch_graphs"]] * mix["distinct_batches"]
    return generate.MoleculeDraw(seed, generate.TRAIN_STREAM, chunks, cfg["data"]["keig"],
                                 workers)


def draw_pool(cfg: dict, mix: dict, seed: int, workers: int):
    """The serving pool, in request-sized chunks, drawn in the background."""
    n = mix["pool_graphs"] // mix["request_graphs"]
    return generate.MoleculeDraw(seed, generate.SERVE_STREAM, [mix["request_graphs"]] * n,
                                 cfg["data"]["keig"], workers)


def param_spec(cfg: dict):
    return ref.param_spec(cfg["model"])


def graphs(raw) -> int:
    return len(raw)


def shape(cfg: dict, raw) -> dict:
    return ref.shape_of(raw)


# -- the port --------------------------------------------------------------


def program_model(cfg: dict, state: dict, device):
    from hl_hgat_tpu_torch.models import presets
    m = cfg["model"]
    model, _ = presets.zinc_pyr(channels=m["channels"], filters=m["filters"], k=m["k"],
                                keig=m["keig"], mlp_channels=m["mlp_channels"],
                                compute_dtype=cfg["dtype"], device=device)
    model.load_state_dict(state, strict=True)
    return model


def program_trainer(cfg: dict, model, device):
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    t = cfg["trainer"]
    return Trainer(model, TrainerConfig(task=t["task"], lr=t["lr"],
                                        weight_decay=t["weight_decay"]), device=device)


def program_samples(raw):
    """The port's samples of raw molecules (its own Laplacians)."""
    from hl_hgat_tpu_torch.complex.build import build_complex

    return [build_complex(np.stack([m["src"], m["dst"]]), m["n"], x_t=m["x_t"], x_s=m["x_s"],
                          y=m["y"]) for m in raw]


def program_batch(cfg: dict, raw):
    """The port's packed training batch on the host."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed

    lay = cfg["layout"]
    return collate_dense_packed(program_samples(raw), node_cap=lay["node_cap"],
                                edge_cap=lay["edge_cap"])


def program_predictor(cfg: dict, model, mix: dict, device):
    from hl_hgat_tpu_torch.serving import Predictor

    lay = cfg["layout"]
    return Predictor(model, batch_size=mix["request_graphs"], node_cap=lay["node_cap"],
                     edge_cap=lay["edge_cap"], device=device)


# -- the reference ---------------------------------------------------------


def reference_loss(cfg: dict, device, prec):
    """``fn(params, raw batch) -> loss`` in training mode."""
    def loss_of(p, raw):
        batch = ref.make_batch(raw, device, prec.dtype)
        return ref.loss(ref.forward(p, batch, cfg["model"], train=True, prec=prec), batch["y"])
    return loss_of


def reference_predict(cfg: dict, device, prec):
    """``fn(params, raw molecules) -> [graphs] predictions`` in eval mode."""
    def predict(p, raw):
        batch = ref.make_batch(raw, device, prec.dtype)
        p = {k: v.to(prec.dtype) for k, v in p.items()}
        return ref.forward(p, batch, cfg["model"], train=False, prec=prec)
    return predict
