"""Host ms a request spends in the loader making its batches (host pack)
inside ``Predictor.__call__``, the loader's set-up included."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "collate", per_unit=True)
