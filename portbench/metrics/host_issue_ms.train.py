"""Host ms a training step takes to issue: the span around each
``Trainer.train_step`` call in the window, which reads nothing back."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "train_step")
