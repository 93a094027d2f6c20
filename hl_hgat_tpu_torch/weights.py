"""Carry JAX/flax model variables over to the port's ``state_dict``.

The port's module names follow the flax parameter paths, so a leaf at
``params/backbone/NEInt00/WV_Node/TorchLinear_0/kernel`` becomes
``backbone.NEInt00.WV_Node.TorchLinear_0.weight``.  Leaves are renamed
and reshaped as follows:

* ``kernel`` [in, out] → ``weight`` [out, in] (transposed);
* ``weights`` (Laguerre [K, C, F]) → ``weight``, unchanged;
* ``embedding`` → ``weight``; BN ``scale``/``offset`` → ``weight``/``bias``;
* batch stats ``mean``/``var`` → ``running_mean``/``running_var``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

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
