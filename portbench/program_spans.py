"""The port's own spans and counters (``hl_hgat_tpu_torch.utils.profiling``),
for the per-layer metrics that read them.

The harness imports a cell's per-layer readers only for a traced run
(``spec.load_cell(traced=True)``), before the run sets up.  Importing this
module from such a reader turns the port's tracing on there: the port then
records its spans and counts through set-up, the window and the profiled
segment, and each span is also a profiler range, which the trace's idle-gap
labels name (``trace.py``).  An untraced run loads none of this.

A reader takes the window's units of work (requests or steps): the port
numbers its units in the order they open, the last ``rec.trace_units`` of
them are the profiled segment's and the ``rec.units`` before them the
window's; set-up's come first.  Each of those units has to be one closed
root span of the cell's kind (``serve.request`` or ``train.step``), else
the count does not line up and the reader gives None; so it does where the
port has no recorder (an older tree) or lost spans past its cap.
"""

from __future__ import annotations

import dataclasses

from portbench import readers

try:
    from hl_hgat_tpu_torch.utils import profiling
except ImportError:
    profiling = None
if getattr(profiling, "enable", None) is None:
    profiling = None
else:
    profiling.enable()


# a unit's root span, by the first word of its spans' names
ROOTS = {"serve": "serve.request", "train": "train.step"}


@dataclasses.dataclass
class Window:
    spans: dict  # span name -> [seconds], of the window's units
    counters: dict  # counter name -> its sum over the window's units
    units: int


def _roots_line_up(snap, lo: int, root: str) -> bool:
    """Every unit from ``lo`` on is one closed span ``root`` opened outside
    any other unit."""
    roots: dict = {}
    for s in snap.spans:
        if s.unit is not None and s.unit >= lo and (
                s.parent is None or snap.spans[s.parent].unit != s.unit):
            roots.setdefault(s.unit, []).append(s)
    return sorted(roots) == list(range(lo, snap.units)) and all(
        len(r) == 1 and r[0].name == root and r[0].end_ns is not None
        for r in roots.values())


def window(rec, root: str) -> Window | None:
    """The port's spans and counts of the window's units, each a span
    ``root``, or None."""
    if profiling is None or rec.units <= 0:
        return None
    snap = profiling.snapshot()
    hi = snap.units - rec.trace_units
    lo = hi - rec.units
    if snap.dropped or lo < 0 or not _roots_line_up(snap, lo, root):
        return None
    spans, counters = {}, {}
    for s in snap.spans:
        if s.unit is not None and lo <= s.unit < hi and s.end_ns is not None:
            spans.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-9)
    for unit, counts in snap.unit_counters.items():
        if unit is not None and lo <= unit < hi:
            for name, n in counts.items():
                counters[name] = counters.get(name, 0) + n
    return Window(spans, counters, rec.units)


def span_ms(rec, name: str):
    """ms a unit of the window spends in the port's spans ``name``."""
    w = window(rec, ROOTS[name.split(".")[0]])
    if w is None:
        return None
    return readers.span_ms(dataclasses.replace(rec, spans=w.spans), name, per_unit=True)


def counter_per_unit(rec, name: str, root: str):
    """The port's counter ``name`` a unit ``root`` of the window."""
    w = window(rec, root)
    if w is None:
        return None
    return w.counters.get(name, 0) / w.units
