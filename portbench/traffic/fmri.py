"""Synthetic fMRI subjects on the Shen-268 skeleton (NumPy only).

``series`` is a frozen copy of ``hl_hgat_tpu_torch/data/synthetic.py::
synthetic_fmri_series`` (the same draws as the JAX package's generator): a
latent network signal plus noise, the score tied to the strength of one
latent component.  ``skeleton`` reads the Shen-268 study skeleton and the
reference run's MLGC pyramid (HL-HGAT-DEMO OHBM_DEMO.ipynb cell 46: pooled
assignments ``pos_t*``/``pos_s*``, ∞ where a simplex is dropped, and the
coarse edge lists), copied from the reference fixture into ``shen268.npz``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SKELETON_FILE = Path(__file__).with_name("shen268.npz")


def series(rng: np.random.Generator, n_subjects: int, n_rois: int, t_len: int, *,
           k_latent: int = 4, y_mean: float = 95.1377, y_std: float = 7.3):
    """(timeseries [N, R, T] float64, scores [N])."""
    mixing = rng.standard_normal((n_rois, k_latent))
    ts_all = np.empty((n_subjects, n_rois, t_len))
    scores = np.empty(n_subjects)
    for s in range(n_subjects):
        strength = rng.uniform(0.5, 2.0)
        lat = rng.standard_normal((k_latent, t_len))
        lat[0] *= strength
        ts_all[s] = mixing @ lat + 0.5 * rng.standard_normal((n_rois, t_len))
        scores[s] = y_mean + y_std * (strength - 1.25)
    return ts_all, scores


def skeleton() -> dict[str, np.ndarray]:
    with np.load(SKELETON_FILE) as z:
        return {k: z[k] for k in z.files}
