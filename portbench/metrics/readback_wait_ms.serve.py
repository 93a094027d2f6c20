"""Host ms a request spends reading its answer back (``serve.readback``:
the host waits there for the card), the port's own span, a request of the
window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.readback")
