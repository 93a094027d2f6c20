"""MB (10^6 bytes) a step's band preparations write (the port's
``band_prep_bytes`` counter), a step of the window: 0 while every operand
comes from the cache.  None where the port counts no band launch (a tree
without these counters)."""

from portbench.program_spans import window


def read(rec):
    w = window(rec, "train.step")
    if w is None or "band_launches" not in w.counters:
        return None
    return w.counters.get("band_prep_bytes", 0) / w.units / 1e6
