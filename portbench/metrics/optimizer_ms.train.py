"""Host ms a step spends in the optimizer (``train.optimizer``: Adam's
update, issued), the port's own span, a step of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "train.optimizer")
