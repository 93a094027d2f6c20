"""Host ms a request spends packing its batches (``serve.pack``:
``pack_indices`` and ``collate_packed_compact`` a batch), the port's own
span, a request of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.pack")
