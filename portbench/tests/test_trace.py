"""The trace reader on a hand-made Chrome trace: busy time as a union, conv
work found by ranges and autograd sequence numbers (not by kernel names),
GEMMs by name, idle gaps labelled by the host op."""

from __future__ import annotations

import json

import pytest

from portbench import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_read(tmp_path):
    ev = [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        # conv forward: a range holding a numbered op that launches kernel 1
        _x("user_annotation", trace.LAGUERRE, 10, 50),
        _x("cpu_op", "_Fused", 12, 40, **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        # an unrelated op launching a GEMM
        _x("cpu_op", "aten::mm", 100, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 5, correlation=2),
        # the conv's backward on the autograd thread launches kernel 3
        _x("cpu_op", trace.BACKWARD_PREFIX + " _FusedBackward", 400, 60, tid=2,
           **{"Sequence number": 7}),
        _x("cuda_runtime", "cudaLaunchKernel", 410, 5, tid=2, correlation=3),
        _x("cpu_op", "aten::item", 600, 300),
        _x("kernel", "fused_fwd_mma_kernel", 30, 100, tid=7, correlation=1),
        _x("kernel", "sm90_xmma_gemm_f32", 120, 100, tid=7, correlation=2),  # overlaps 1
        _x("kernel", "fused_bwd_dx_mma_kernel", 420, 80, tid=7, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rep = trace.read(str(path), [(1e-5, 3e-5)])
    assert rep.window_s == pytest.approx(1e-3)
    assert rep.busy_s == pytest.approx((220 - 30 + 80) * 1e-6)  # [30, 220) ∪ [420, 500)
    assert rep.gemm_s == pytest.approx(100e-6)
    assert rep.laguerre_s == pytest.approx(180e-6)
    assert rep.laguerre_bound_s == pytest.approx(4e-5)
    assert rep.idle_gaps[0][0] == "aten::item"  # the gap [500, 1000)
    assert rep.idle_gaps[0][1] == pytest.approx(500e-6)
    assert [n for n, _ in rep.device_ops][:2] == ["fused_fwd_mma_kernel", "sm90_xmma_gemm_f32"]


def test_unmatched_ranges_give_no_conv_time(tmp_path):
    ev = [_x("user_annotation", trace.WINDOW, 0, 100),
          _x("user_annotation", trace.LAGUERRE, 10, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
          _x("kernel", "k", 20, 10, tid=7, correlation=1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rep = trace.read(str(path), [])  # a call the wrapper did not see
    assert rep.laguerre_s == 0.0 and rep.laguerre_bound_s == 0.0


def test_idle_share_is_busy_against_the_untraced_window():
    from portbench import harness, readers

    rec = harness.RunRecord(window_s=10.0, units=100, trace_units=4)
    rec.trace = trace.TraceReport(window_s=0.8, busy_s=0.3, gemm_s=0.0, laguerre_s=0.0,
                                  laguerre_bound_s=0.0, device_ops=[], idle_gaps=[])
    # 75 ms busy a unit in the trace against 100 ms a unit in the window
    assert readers.device_idle_pct(rec) == pytest.approx(25.0)
    rec.trace = None
    assert readers.device_idle_pct(rec) is None
