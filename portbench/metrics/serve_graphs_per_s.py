"""Graphs returned in the window over the window, which closes when the
request running at its end returns."""


def read(rec):
    return rec.graphs / rec.window_s if rec.window_s > 0 else None
