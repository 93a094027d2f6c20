"""Host ms a request spends setting up the port's loader (``serve.loader``:
the samples relabelled, ``BucketedLoader.__post_init__``'s pads and
``FlatSamples``), the port's own span, a request of the window."""

from portbench.program_spans import span_ms


def read(rec):
    return span_ms(rec, "serve.loader")
