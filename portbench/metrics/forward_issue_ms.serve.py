"""Host ms a request spends issuing its forward (``serve.forward``: the
inflate and the eval forward, launched), the port's own span, a request of
the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.forward")
