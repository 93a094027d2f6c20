"""Device figures from one ``torch.profiler`` session's Chrome trace.

The traced segment runs inside a host range ``portbench.window`` opened after
a synchronize and closed after another, so the range spans all of its device
work.  Device activity is every kernel, memcpy and memset; its busy time is
the union of their intervals, never their sum.  A kernel belongs to the host
range that was open on the launching thread when it was launched (runtime
and driver launch events carry the kernel's correlation id).  The Laguerre
convs are found through ranges ``portbench.laguerre`` that the benchmark
opens around each ``LaguerreConv`` call, and their backward through the
autograd sequence numbers of the operators recorded inside those ranges:
no kernel is picked by its name, except the GEMM kernels of ``gemm_s``,
which are cuBLAS's and CUTLASS's.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW, LAGUERRE = "portbench.window", "portbench.laguerre"
BACKWARD_PREFIX = "autograd::engine::evaluate_function:"
GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "nvjet", "xmma", "cublas")


@dataclasses.dataclass
class TraceReport:
    window_s: float
    busy_s: float
    gemm_s: float
    laguerre_s: float  # device time of the convs' work, forward and backward
    laguerre_bound_s: float  # the least time of the same work (counts.conv_bound_s)
    device_ops: list  # [[name, seconds]], the ten that took most time
    idle_gaps: list  # [[host op at the gap, seconds]], the ten longest


class _Ranges:
    """Nested host ranges (start, end, payload) of one thread."""

    def __init__(self, ranges):
        self.r = sorted(ranges)
        self.starts = [r[0] for r in self.r]

    def innermost(self, ts):
        """The range holding ``ts`` that starts last (among the 4096 that start
        last before it), or None."""
        i = bisect.bisect_right(self.starts, ts)
        for j in range(i - 1, max(i - 4096, -1), -1):
            if self.r[j][1] >= ts:
                return self.r[j]
        return None


def _union(intervals, lo, hi):
    total, cur_s, cur_e, gaps, last = 0.0, None, None, [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            gaps.append((last if cur_e is None else cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
        gaps.append((cur_e, hi))
    else:
        gaps.append((lo, hi))
    return total, [(a, b) for a, b in gaps if b > a]


def read(path: str, conv_calls: list) -> TraceReport:
    """``conv_calls`` holds, per ``portbench.laguerre`` range in order, the
    (forward bound s, backward bound s) of that call."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device, launches, host, windows, convs, backward = [], {}, {}, [], [], {}
    for e in events:
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"], args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in HOST_CATS:
            host.setdefault(e.get("tid"), []).append((ts, ts + dur, e))
            if e["name"] == WINDOW:
                windows.append((ts, ts + dur, e.get("tid")))
            elif e["name"] == LAGUERRE:
                convs.append((e.get("tid"), ts, ts + dur))
            elif e["name"].startswith(BACKWARD_PREFIX) and "Sequence number" in args:
                backward.setdefault(args["Sequence number"], []).append(
                    (e.get("tid"), ts, ts + dur))
    if not windows:
        raise ValueError(f"no {WINDOW} range in the trace")
    lo, hi, main = windows[0]
    convs.sort(key=lambda c: c[1])

    # which conv range (forward) or conv backward range a kernel was launched in
    owner = {}  # tid -> _Ranges of (start, end, (conv index, part))
    numbered = {tid: sorted((ts, te, (ev.get("args") or {})["Sequence number"])
                            for ts, te, ev in evs
                            if "Sequence number" in (ev.get("args") or {})
                            and not ev["name"].startswith(BACKWARD_PREFIX))
                for tid, evs in host.items()}
    for idx, (tid, s, e) in enumerate(convs):
        owner.setdefault(tid, []).append((s, e, (idx, 0)))
        ops = numbered.get(tid, [])
        for ts, te, seq in ops[bisect.bisect_left(ops, (s,)):]:
            if ts > e:
                break
            if te <= e:
                for btid, bs, be in backward.get(seq, ()):
                    owner.setdefault(btid, []).append((bs, be, (idx, 1)))
    owner = {tid: _Ranges(r) for tid, r in owner.items()}

    part_time = {}
    by_name = {}
    gemm = 0.0
    for s, e, name, corr in device:
        if e <= lo or s >= hi:
            continue
        dur = (min(e, hi) - max(s, lo)) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + dur
        if any(m in name for m in GEMM_MARKS):
            gemm += dur
        launch = launches.get(corr)
        if launch is None or launch[0] not in owner:
            continue
        hit = owner[launch[0]].innermost(launch[1])
        if hit is not None:
            part_time[hit[2]] = part_time.get(hit[2], 0.0) + dur
    lag_s = lag_bound = 0.0
    if len(convs) == len(conv_calls):  # else the ranges cannot be matched to their calls
        for (idx, part), t in part_time.items():
            lag_s += t
            lag_bound += conv_calls[idx][part]

    busy, gaps = _union([(s, e) for s, e, _, _ in device], lo, hi)
    ranges = _Ranges([(s, e, ev["name"]) for s, e, ev in host.get(main, ())
                      if ev["name"] != WINDOW])
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        hit = ranges.innermost((a + b) / 2)
        labelled.append([hit[2] if hit else "python, no operator", (b - a) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return TraceReport(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, gemm_s=gemm,
                       laguerre_s=lag_s, laguerre_bound_s=lag_bound,
                       device_ops=[[n, t] for n, t in top], idle_gaps=labelled)
