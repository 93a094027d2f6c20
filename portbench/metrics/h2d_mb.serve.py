"""MB (10^6 bytes) a request moves from the host to the card: the port's
``h2d_bytes`` counter (the tensors ``CompactBatch.to`` takes off the host),
a request of the window."""

from portbench.program_spans import counter_per_unit


def read(rec):
    n = counter_per_unit(rec, "h2d_bytes", "serve.request")
    return None if n is None else n / 1e6
