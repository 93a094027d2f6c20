"""Device ms a traced training step spends in cuBLAS and CUTLASS GEMM kernels."""


def read(rec):
    t = rec.trace
    if t is None or rec.trace_units == 0:
        return None
    return 1e3 * t.gemm_s / rec.trace_units
