"""Values made from a tensor, kept for as long as the tensor lives unedited.

A batch's operators reach the kernels once per forward and per conv: the
bfloat16 cast of each (``dispatch.cast_operators``) and the band kernels'
prepared operator (``laguerre_dense.band_operator``) are made from them.
`TensorCache` keys such a value on the tensor's identity and checks its
version counter, so that an in-place edit makes it anew; the entry goes when
the tensor is freed.  A value must not hold its tensor, or the entry would
keep it alive.
"""

from __future__ import annotations

import weakref

import torch


def tensor_version(t: torch.Tensor) -> int | None:
    """t's version counter; None for an inference tensor (made under
    ``torch.inference_mode``), which has none: it can be edited in place
    only inside inference mode, where nothing edits a batch's operators, so
    it is cached by identity alone."""
    return None if t.is_inference() else t._version


class TensorCache:
    """``(id(t), tag) -> (weak reference to t, t's version, value)``."""

    def __init__(self) -> None:
        self.entries: dict[tuple[int, object], tuple[weakref.ref, int | None, object]] = {}

    def lookup(self, t: torch.Tensor, tag):
        """The value stored for (t, tag) while t is the same tensor at the
        same version, else None."""
        hit = self.entries.get((id(t), tag))
        if hit is not None and hit[0]() is t and hit[1] == tensor_version(t):
            return hit[2]
        return None

    def put(self, t: torch.Tensor, tag, value) -> None:
        key = (id(t), tag)
        # the callback keeps its own reference to the entries: at interpreter
        # exit the module's globals may already be gone
        self.entries[key] = (weakref.ref(t, lambda _, key=key, entries=self.entries:
                                         entries.pop(key, None)),
                             tensor_version(t), value)

    def __contains__(self, key: tuple[int, object]) -> bool:
        return key in self.entries

    def clear(self) -> None:
        self.entries.clear()
