"""Host ms a step spends issuing its backward (``train.backward``), the port's
own span, a step of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "train.backward")
