"""Host ms a step spends issuing its forward (``train.forward``: the batch
on the device, ``zero_grad``, forward and loss), the port's own span, a
step of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "train.forward")
