"""Dataset functions of the brain family (``hl_hgat_tpu/data/datasets.py``).

``fc2mask`` derives a group skeleton from a stack of functional
connectivity matrices; ``brain_sample`` turns one subject's time courses
into a sample on a shared structure pyramid.  Host-side NumPy.
"""

from __future__ import annotations

import numpy as np

from hl_hgat_tpu_torch.complex.build import GraphSample


def fc2mask(fcs: np.ndarray, percent: float = 0.25, mode: int = 1) -> np.ndarray:
    """Group-level FC skeleton (reference FC2mask,
    HL-HGAT-DEMO/lib/Hodge_Dataset.py:148-178), strictly upper-triangular:

    * mode 1: threshold at the k-th largest positive |mean FC| entry of the
      full matrix, ``k = int(percent · n²)``, strict ``>``;
    * mode 2: coefficient of variation std/|mean| (unbiased std), threshold
      at the k-th smallest positive entry, strict ``<``;
    * mode 3: per-ROI top ``int(n · percent)`` with the reference's
      loop-variable quirk: the row index is overwritten by the top-k index
      tensor before the threshold is taken, so the k rows named by the
      indices are thresholded at row r's cutoff and written back to those
      rows; then symmetrized and capped at 1.
    """
    n = fcs.shape[-1]
    mean_fc = np.abs(fcs.mean(0))
    if mode == 1:
        k = int(percent * n * n)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        thresh = np.sort(mean_fc[mean_fc > 0])[-k]
        mask = (mean_fc > thresh).astype(np.float64)
    elif mode == 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            cv = fcs.std(0, ddof=1) / mean_fc
        k = int(percent * n * n)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        thresh = np.sort(cv[cv > 0])[k - 1]
        mask = (cv < thresh).astype(np.float64)
    elif mode == 3:
        mask = np.zeros_like(mean_fc, dtype=np.float64)
        k = int(n * percent)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        for r in range(n):
            row = mean_fc[r]
            idx = np.argsort(-row, kind="stable")[:k]
            mask[idx] = (mean_fc[idx] > row[idx[-1]]).astype(np.float64)
        mask = mask + mask.T
        mask[mask == 2] = 1
    else:
        raise ValueError(f"unknown mode {mode}")
    return np.triu(mask, 1).astype(np.float32)


def brain_sample(
    timeseries: np.ndarray,
    skeleton_src: np.ndarray,
    skeleton_dst: np.ndarray,
    shared_levels,
    shared_pools,
    y: float,
    *,
    crop_len: int | None = None,
    rng: np.random.Generator | None = None,
    y_mean: float = 95.1377,
    y_std: float = 7.3,
) -> GraphSample:
    """One subject (reference Brain_MLGC_ALL.get(),
    HL-HGAT-DEMO/lib/Hodge_Dataset.py:110-145): an optional random temporal
    crop (one ``rng.integers`` draw), the time courses z-scored by one
    scalar mean and unbiased std over all ROIs and time points, the Pearson
    FC sampled at the skeleton's edges as the edge feature, the target
    z-scored; the shared structure pyramid is reused."""
    ts = timeseries
    if crop_len is not None and rng is not None and ts.shape[1] > crop_len:
        start = int(rng.integers(0, ts.shape[1] - crop_len + 1))
        ts = ts[:, start : start + crop_len]
    ts = (ts - ts.mean()) / max(float(ts.std(ddof=1)), 1e-12)
    fc = np.corrcoef(ts)
    return GraphSample(
        x_t=ts.astype(np.float32),
        x_s=fc[skeleton_src, skeleton_dst].reshape(-1, 1).astype(np.float32),
        y=np.asarray([(y - y_mean) / y_std], np.float32),
        levels=list(shared_levels),
        pools=list(shared_pools),
    )
