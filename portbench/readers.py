"""What the metric readers under ``metrics/`` share.  Each takes the run's
record (``harness.RunRecord``) and returns a number, or None where the run
has nothing to read."""

from __future__ import annotations


def mfu_pct(rec):
    """The window's model FLOPs (the reference's count) over the window and
    the card's peak."""
    if rec.window_s <= 0 or rec.flops <= 0:
        return None
    return 100.0 * rec.flops / rec.window_s / rec.peak_flops


def laguerre_roofline_pct(rec):
    """The least time of the traced Laguerre convs' work over its device time."""
    t = rec.trace
    if t is None or t.laguerre_s <= 0 or t.laguerre_bound_s <= 0:
        return None
    return 100.0 * t.laguerre_bound_s / t.laguerre_s


def device_idle_pct(rec):
    """The share of the window's time a unit of work leaves the device idle:
    1 − (the traced units' device busy time a unit) / (the window's wall
    time a unit).  The busy time is the union of the traced segment's device
    intervals; the wall time is the untraced window's, since the profiler's
    host cost slows the traced units' issue and would add idle time of its
    own."""
    t = rec.trace
    if t is None or t.busy_s <= 0 or rec.trace_units == 0 or rec.units == 0 \
            or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / rec.trace_units) / (rec.window_s / rec.units))


def span_ms(rec, name: str, per_unit: bool = False):
    """Mean ms of the spans ``name``, or their total ms per unit of work."""
    spans = rec.spans.get(name)
    if not spans:
        return None
    return 1e3 * sum(spans) / (rec.units if per_unit else len(spans))
