"""Checkpoint and resume (``hl_hgat_tpu/train/checkpoint.py``), on
``torch.save`` / ``torch.load``.

    save_checkpoint("runs/zinc_fold0", trainer, extra=dict(epoch=3, metric=0.41, lr=1e-3))
    restore_checkpoint("runs/zinc_fold0", trainer)         # full state, for a resume
    restore_checkpoint("runs/zinc_fold0", model)           # the model alone, for serving

``<ckpt_dir>/state.pt`` holds up to four sections, each what the JAX
``TrainState`` holds in its own form:

* ``model``: the model's ``state_dict`` (parameters and BN running
  statistics; the JAX ``params`` and ``batch_stats``);
* ``optimizer``: the Adam ``state_dict`` (``exp_avg``, ``exp_avg_sq`` and
  ``step`` per parameter, the lr; the JAX optax state and ``step``);
* ``generator``: the state of ``Trainer.generator`` (PE flips, TSP
  augmentation draws);
* ``rng``: torch's CPU and CUDA random states, from which dropout draws
  (where the JAX ``TrainState.rng`` stands).

``<ckpt_dir>/meta.json`` holds the host-side metadata the trainer passes
as ``extra`` (``epoch``, ``metric``, ``lr`` and, in ``latest/``,
``best_metric``).  Every tensor is saved from the CPU, so a file written on
the card loads on a machine without one, and ``torch.load(...,
weights_only=True)`` reads every file this module writes.  A file with the
``model`` section alone (a converted or exported model) serves and
evaluates; a resume from it raises and names the missing sections.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import torch

STATE_FILE = "state.pt"
FULL_SECTIONS = ("model", "optimizer", "generator", "rng")


def _cpu(obj):
    """``obj`` with every tensor copied to the CPU (nested dicts, lists)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, Mapping):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _rng_state(device: torch.device) -> dict:
    state = {"cpu": torch.get_rng_state()}
    if device.type == "cuda":
        state["cuda"] = torch.cuda.get_rng_state(device)
    return state


def trainer_sections(trainer) -> dict:
    """The four sections of a ``train.Trainer``'s full state."""
    return {
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "generator": trainer.generator.get_state(),
        "rng": _rng_state(trainer.device),
    }


def state_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, STATE_FILE)


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(state_path(ckpt_dir))


def save_checkpoint(ckpt_dir: str, trainer_or_parts, *, extra: dict | None = None) -> str:
    """Write ``<ckpt_dir>/state.pt`` and, given ``extra``, ``meta.json``.

    ``trainer_or_parts``: a ``train.Trainer`` (its full state) or a
    mapping of sections (``{"model": model.state_dict()}`` for a model
    alone).  Returns the state file's path."""
    if isinstance(trainer_or_parts, Mapping):
        sections = dict(trainer_or_parts)
    else:
        sections = trainer_sections(trainer_or_parts)
    if "model" not in sections:
        raise ValueError("a checkpoint needs a 'model' section")
    unknown = set(sections) - set(FULL_SECTIONS)
    if unknown:
        raise ValueError(f"unknown checkpoint sections {sorted(unknown)}")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = state_path(ckpt_dir)
    # write then rename: a run killed mid-save leaves the last good file
    tmp = path + ".tmp"
    torch.save(_cpu(sections), tmp)
    os.replace(tmp, path)
    if extra is not None:
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
            json.dump(extra, f)
    return path


def load_state(ckpt_dir: str) -> dict:
    """The sections of ``<ckpt_dir>/state.pt``, on the CPU (``weights_only``
    load)."""
    return torch.load(state_path(ckpt_dir), map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, target, *, full: bool | None = None) -> dict:
    """Load ``<ckpt_dir>/state.pt`` into ``target`` in place and return the
    sections read.

    ``target`` is a ``torch.nn.Module`` (the ``model`` section) or a
    ``train.Trainer``.  A trainer gets every section the file holds; with
    ``full=True`` (the default for a trainer) a file without all four
    raises, naming the missing ones, before anything is loaded."""
    if isinstance(target, torch.nn.Module):
        model, trainer = target, None
    else:
        model, trainer = target.model, target
    # read on the CPU: load_state_dict copies onto the model's device, and
    # the optimizer keeps Adam's step counts on the CPU, as a fresh one does
    sections = load_state(ckpt_dir)
    if full is None:
        full = trainer is not None
    missing = [s for s in (FULL_SECTIONS if full else ("model",)) if s not in sections]
    if missing:
        raise ValueError(
            f"{state_path(ckpt_dir)} holds {sorted(sections)}; missing section(s) "
            f"{missing}: a resume needs the full training state")
    model.load_state_dict(sections["model"])
    if trainer is None:
        return sections
    if "optimizer" in sections:
        trainer.optimizer.load_state_dict(sections["optimizer"])
    if "generator" in sections:
        trainer.generator.set_state(sections["generator"])
    if "rng" in sections:
        rng = sections["rng"]
        torch.set_rng_state(rng["cpu"])
        if "cuda" in rng and trainer.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"], trainer.device)
    return sections


def load_metadata(ckpt_dir: str) -> dict:
    meta_path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)
