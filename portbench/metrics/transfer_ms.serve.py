"""Host ms a request spends moving its batches to the card (``serve.transfer``:
``CompactBatch.to``), the port's own span, a request of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.transfer")
