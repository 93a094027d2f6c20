"""What both drivers share: the run's record, the benchmark's own spans and
conv ranges around calls into the port, the one profiler session, and the
device's description."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import subprocess
import time

import torch

from portbench import counts, trace


@dataclasses.dataclass
class RunRecord:
    """One run of a cell: what the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window, closed by a synchronize
    units: int = 0  # training steps or requests in the window
    graphs: int = 0  # graphs trained or returned in the window
    flops: float = 0.0  # the reference's count of the window's model work
    peak_flops: float = counts.PEAK_FLOPS["float32"]  # of the configuration's dtype
    latencies_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [seconds]
    trace: trace.TraceReport | None = None
    trace_units: int = 0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)  # name -> (value, limit)

    @property
    def correct(self) -> bool:
        """Every answer came, and every number compared is within its limit
        (a number without a limit, or not a number, fails)."""
        return self.failed == 0 and bool(self.checks) and all(
            lim is not None and v == v and v <= lim for v, lim in self.checks.values())


class Spans:
    """Host-clock spans of the benchmark's own, in memory."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t)


class ConvRanges:
    """While installed, every ``LaguerreConv`` call of ``model`` runs inside a
    ``portbench.laguerre`` profiler range and leaves the bounds of its
    forward and backward work (``counts.conv_bound_s``) in ``calls``, in call
    order.  The modules are wrapped by instance; the port is not edited."""

    def __init__(self, model, dtype: str):
        from hl_hgat_tpu_torch.nn.conv import LaguerreConv

        self.calls: list[tuple[float, float]] = []
        self.convs = [m for m in model.modules() if isinstance(m, LaguerreConv)]
        self.dtype = dtype

    def _wrap(self, conv):
        inner = conv.forward

        def forward(x, lap):
            with torch.profiler.record_function(trace.LAGUERRE):
                out = inner(x, lap)
            shapes = (tuple(lap.shape), tuple(x.shape), tuple(conv.weight.shape))
            self.calls.append((
                counts.conv_bound_s(*shapes, backward=False, dtype=self.dtype),
                counts.conv_bound_s(*shapes, backward=True, dtype=self.dtype)))
            return out
        return forward

    def __enter__(self):
        for conv in self.convs:
            conv.forward = self._wrap(conv)
        return self

    def __exit__(self, *exc):
        for conv in self.convs:
            del conv.forward


def sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def profile_segment(run_units, path: str, model, dtype: str, device) -> trace.TraceReport:
    """The one profiler session of a process: ``run_units()`` inside a
    ``portbench.window`` range between two synchronizes, with the model's
    conv ranges installed; the Chrome trace is written to ``path`` and
    read back.  (On the CPU, for the tests, the host is traced alone.)"""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with ConvRanges(model, dtype) as ranges, torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            run_units()
            sync(device)
    prof.export_chrome_trace(path)
    try:
        return trace.read(path, ranges.calls)
    finally:
        os.remove(path)


def free_device_memory(device):
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def device_info(record: RunRecord) -> dict:
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                memory_peak_bytes=record.memory_peak_bytes)
    if record.trace is not None:
        info.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
    return info


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
