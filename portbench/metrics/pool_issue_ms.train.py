"""Host ms a step spends issuing its gated pools (``model.pool``: each pooled
block's gates, their multiply into the stacks and the coarsening), the
port's own span inside ``train.forward``, a step of the window; None where
the port has no such span."""

import dataclasses

from portbench import readers
from portbench.program_spans import window


def read(rec):
    w = window(rec, "train.step")
    if w is None:
        return None
    return readers.span_ms(dataclasses.replace(rec, spans=w.spans), "model.pool", per_unit=True)
