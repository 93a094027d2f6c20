"""Carry JAX/flax model variables over to the port's ``state_dict``, and
the port's tensors (parameters, gradients, BN statistics) back to flax paths.

The port's module names follow the flax parameter paths, so a leaf at
``params/backbone/NEInt00/WV_Node/TorchLinear_0/kernel`` becomes
``backbone.NEInt00.WV_Node.TorchLinear_0.weight``.  Leaves are renamed
and reshaped as follows:

* ``kernel`` [in, out] → ``weight`` [out, in] (transposed);
* ``weights`` (Laguerre [K, C, F]) → ``weight``, unchanged;
* ``embedding`` → ``weight``; BN ``scale``/``offset`` → ``weight``/``bias``;
* batch stats ``mean``/``var`` → ``running_mean``/``running_var``.

``to_flax_paths`` is the inverse, for comparing a gradient or a trained
parameter leaf by leaf with a JAX tree.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {
    "kernel": "weight",
    "weights": "weight",
    "embedding": "weight",
    "bias": "bias",
    "scale": "weight",
    "offset": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_flax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (array leaves) → state_dict."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            if path[-1] not in _LEAF_NAMES:
                raise KeyError(f"unknown leaf {'/'.join(path)}")
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            name = ".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))
            state[name] = torch.tensor(arr)
    return state


def _flax_leaf(module: nn.Module, leaf: str) -> str:
    """The flax name of ``module``'s direct tensor ``leaf``."""
    if leaf in ("running_mean", "running_var"):
        return {"running_mean": "mean", "running_var": "var"}[leaf]
    if isinstance(module, nn.Embedding):
        return {"weight": "embedding"}[leaf]
    if isinstance(module, nn.Linear):
        return {"weight": "kernel", "bias": "bias"}[leaf]
    if hasattr(module, "running_mean"):  # MaskedBatchNorm
        return {"weight": "scale", "bias": "offset"}[leaf]
    if leaf == "weight" and module.weight.dim() == 3:  # LaguerreConv [K, C, F]
        return "weights"
    return {"bias": "bias"}[leaf]


def to_flax_paths(
    model: nn.Module, tensors: Mapping[str, torch.Tensor]
) -> dict[tuple[str, ...], np.ndarray]:
    """``{state_dict name: tensor}`` → ``{flax path tuple: float32 array}``.

    ``tensors`` holds values shaped like ``model``'s parameters or buffers
    under their ``state_dict`` names — the parameters themselves, their
    ``.grad``s, or the BN running statistics.  The owning module's type
    decides the flax leaf name; a Linear ``weight`` is transposed back to a
    ``kernel``.  Parameter and batch-stat leaves of one module differ in
    their names, so one flat dictionary holds both collections.
    """
    modules = dict(model.named_modules())
    out: dict[tuple[str, ...], np.ndarray] = {}
    for name, tensor in tensors.items():
        owner, _, leaf = name.rpartition(".")
        flax_leaf = _flax_leaf(modules[owner], leaf)
        arr = tensor.detach().float().cpu().numpy()
        if flax_leaf == "kernel":
            arr = arr.T
        out[tuple(owner.split(".")) + (flax_leaf,)] = arr
    return out
