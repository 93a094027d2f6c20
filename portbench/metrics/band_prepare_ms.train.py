"""Host ms a step spends preparing band operands on a cache miss
(``band.prepare``: L's or W's TF32 halves, padded rows), the port's own span,
a step of the window: 0 while every operand comes from the cache.  None
where the port counts no band launch (a tree without these counters)."""

from portbench.program_spans import window


def read(rec):
    w = window(rec, "train.step")
    if w is None or "band_launches" not in w.counters:
        return None
    return 1e3 * sum(w.spans.get("band.prepare", ())) / w.units
