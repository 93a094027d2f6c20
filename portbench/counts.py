"""Work counts and the card's peaks: the yardstick of the roofline and MFU
metrics.

The Laguerre formulas are those of the port's kernel table (PERF.md,
Findings), for one conv of K terms on G blocks of S rows, C input and F
output columns, its operator shared by every block when ``shared``:

    forward  FLOPs 2·G·S·(S·C·(K−1) + K·C·F)
    backward FLOPs 2·G·S·(S·C·(K−1) + 2·K·C·F)
    bytes: every input read once, every output written once.

The backward counts what it needs: the K products g·W_kᵀ, the K − 1 products
with Lᵀ of the adjoint recurrence, and the K products T_kᵀ·g, the terms kept
from the forward (the table's "twice the forward" also counts the fused
kernel's recomputation of the terms).

A model step is counted from the plain reference's shapes: 2·M·K·N for every
[M, K]·[K, N] product of the forward (a Conv1d as its unfolded product), the
same again for each gradient the backward forms (of the input, of the
weight), and 2·nnz·columns for each application of L0 or L1, in the forward
and in the backward where its input needs a gradient.  Elementwise work,
BN, the incidence couplings and the pooling are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM3 3.35 TB/s; TF32 495 TFLOP/s,
# so float32 on the tensor cores as the port's kernels compute it (3xTF32,
# three TF32 products a product) peaks at a third of that.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}


def laguerre_flops(g: int, s: int, c: int, f: int, k: int, *, backward: bool = False) -> int:
    return 2 * g * s * (s * c * (k - 1) + (2 if backward else 1) * k * c * f)


def laguerre_bytes(g: int, s: int, c: int, f: int, k: int, *, shared: bool = False,
                   backward: bool = False, elem: int = 4) -> int:
    """Forward: L, x, W, b in, out out.  Backward: L, the K terms (x the
    first), W and the output's gradient in; the gradients of x, W and b out."""
    lap = (1 if shared else g) * s * s
    x, w, out = g * s * c, k * c * f, g * s * f
    if backward:
        return elem * (lap + k * x + w + out + x + w + f)
    return elem * (lap + x + w + f + out)


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: max(FLOPs / peak, bytes / HBM)."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def conv_bound_s(lap_shape, x_shape, w_shape, *, backward: bool, dtype: str = "float32",
                 elem: int = 4) -> float:
    """``bound_s`` of one Laguerre conv from the shapes it was called with:
    lap [G or 1, S, S], x [G, S, C], weight [K, C, F]."""
    g, s, c = x_shape
    k, _, f = w_shape
    shared = lap_shape[0] == 1 and g > 1
    return bound_s(laguerre_flops(g, s, c, f, k, backward=backward),
                   laguerre_bytes(g, s, c, f, k, shared=shared, backward=backward, elem=elem),
                   dtype)


def product_flops(products, *, backward: bool) -> int:
    """FLOPs of (M, K, N, dx, dw) products: the forward, or the backward."""
    total = 0
    for m, k, n, dx, dw in products:
        unit = 2 * m * k * n
        total += unit * (int(dx) + int(dw)) if backward else unit
    return total


def operator_flops(applications, *, backward: bool) -> int:
    """FLOPs of (nnz, columns, dx) operator applications."""
    return sum(2 * nnz * cols for nnz, cols, dx in applications if dx or not backward)


def model_flops(ref, model: dict, shape: dict, *, train: bool) -> int:
    """One forward (``train=False``) or one training step of the reference
    module ``ref`` (its ``products`` and ``operator_products``)."""
    prods, apps = ref.products(model, shape), ref.operator_products(model, shape)
    total = product_flops(prods, backward=False) + operator_flops(apps, backward=False)
    if train:
        total += product_flops(prods, backward=True) + operator_flops(apps, backward=True)
    return total
