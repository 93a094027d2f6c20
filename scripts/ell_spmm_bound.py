"""Least time an NVIDIA H100 could take for the ELL SpMM kernel
(``hl_hgat_tpu_torch/csrc/ell_spmm.cu``, the port of
``hl_hgat_tpu/ops/pallas_spmm.py::spmm_ell_pallas``), from shapes alone.

    PYTHONPATH=. python scripts/ell_spmm_bound.py   (from the repo root)

Builds the flat-layout batch the training benchmark uses
(``synthetic_zinc_batch(384, seed=0, keig=16, embed_ids=True,
with_ell=True)``), reads the ELL shapes of L0 and L1 and prints, per
operator and feature width C of the zinc_pyr layers, the bound

    bytes = N·W·(4 + 4)  (vals f32 + cols i32, each read once)
          + 2·N·C·es     (x read once, out written once)
    flops = 2·N·W·C      (2·nnz·C for the entries that are not padding)
    bound = max(bytes / 3.35 TB/s, flops / 67 TFLOP/s)

Nothing here runs on a GPU: the numbers are counts from shapes and the
data sheet's peaks, for float32 (es = 4).  ``chip_smoke.py`` computes the
same bound from the tensors it times (with the operations counted on the
non-zero slots only) and prints it beside the measured times.
"""

from __future__ import annotations

import numpy as np

from hl_hgat_tpu_torch.data.synthetic import synthetic_zinc_batch

HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12


def main() -> None:
    batch = synthetic_zinc_batch(384, seed=0, keig=16, embed_ids=True, with_ell=True)
    lvl = batch.levels[0]
    for name, mat in (("L0", lvl.l0), ("L1", lvl.l1)):
        cols, vals = np.asarray(mat.ell_cols), np.asarray(mat.ell_vals)
        n, w = cols.shape
        nnz = int((vals != 0).sum())
        print(f"{name}: N={n} rows, ELL width W={w}, {nnz} non-zeros "
              f"({100 * nnz / (n * w):.1f}% of N·W)")
        for c in (64, 128, 256):
            nbytes = n * w * 8 + 2 * n * c * 4
            flops_padded, flops_real = 2 * n * w * c, 2 * nnz * c
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = flops_padded / PEAK_F32 * 1e3
            print(f"  C={c}: {nbytes / 1e6:.3f} MB -> {by_bytes:.5f} ms by bytes; "
                  f"{flops_padded / 1e6:.2f} MFLOP padded ({flops_real / 1e6:.2f} real) -> "
                  f"{by_ops:.5f} ms by operations; bound {max(by_bytes, by_ops):.5f} ms "
                  f"({'bytes' if by_bytes >= by_ops else 'operations'})")


if __name__ == "__main__":
    main()
