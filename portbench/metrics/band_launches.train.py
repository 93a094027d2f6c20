"""Calls of the Laguerre kernel wrappers a step that took the band kernels
(blocks over 128 rows), forward and backward: the port's ``band_launches``
counter, a step of the window; None where the port counts none."""

from portbench.program_spans import window


def read(rec):
    w = window(rec, "train.step")
    if w is None or "band_launches" not in w.counters:
        return None
    return w.counters["band_launches"] / w.units
