"""The general generator: draws a configuration's raw inputs from the seed.

A traffic mix (``traffic/<name>.json``) gives the counts and rates; a
configuration's adapter calls the generator of its data.  Every
draw is seeded with (seed, stream, chunk), so one seed gives one set of
inputs, and chunks of molecules are drawn by worker processes in parallel
(``spawn``: a worker imports this package's NumPy modules only).
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from portbench.traffic import fmri, zinc_like

TRAIN_STREAM, SERVE_STREAM = 1, 2


class MoleculeDraw:
    """Chunks of ``zinc_like.molecules`` drawn in worker processes; ``get``
    waits for them and stops the workers."""

    def __init__(self, seed: int, stream: int, chunks: list[int], keig: int, workers: int):
        args = [(seed, stream, i, count, keig) for i, count in enumerate(chunks)]
        workers = min(workers, len(args), os.cpu_count() or 1)
        if workers <= 1:
            self._pool, self._result = None, [zinc_like.molecule_chunk(a) for a in args]
            return
        self._pool = multiprocessing.get_context("spawn").Pool(workers)
        self._result = self._pool.map_async(zinc_like.molecule_chunk, args)

    def get(self) -> list[list[dict]]:
        if self._pool is None:
            return self._result
        try:
            return self._result.get()
        finally:
            self._pool.close()
            self._pool.join()


def subjects(seed: int, stream: int, count: int, rois: int, t_len: int):
    """``count`` subjects' series [count, rois, t_len] and scores."""
    return fmri.series(np.random.default_rng([seed, stream]), count, rois, t_len)
