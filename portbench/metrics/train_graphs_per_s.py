"""Graphs (a subject is one graph) trained in the window over the window,
closed by a synchronize."""


def read(rec):
    return rec.graphs / rec.window_s if rec.window_s > 0 else None
