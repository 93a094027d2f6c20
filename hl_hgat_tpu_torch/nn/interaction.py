"""Node–edge interaction (MSI / NodeEdgeInt), value mode
(``hl_hgat_tpu/nn/interaction.py``).

    x_s2t = D⁻¹ · |B1| · x_s      x_t2s = |B1|ᵀ · x_t / 2

and two 2-layer MLPs (Linear→BN→ReLU ×2) on [x_s2t ‖ x_t] and
[x_t2s ‖ x_s] (reference lib/Hodge_Cheb_Conv.py:276-289).  As in the JAX
package the first Linear is applied before the boundary product
(project-then-couple: the coupling runs at width dv, not at the stack
width) and each wide operand is read by one merged GEMM shared by the two
heads.  The wide operands may be tuples of column pieces (the backbone's
dense-concat stacks); the GEMM then sums per-piece products in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from hl_hgat_tpu_torch.nn.gemm import stack_gemm
from hl_hgat_tpu_torch.nn.linear import TorchLinear
from hl_hgat_tpu_torch.nn.norm import MaskedBatchNorm
from hl_hgat_tpu_torch.ops.dispatch import abs_b1_s2t, abs_b1_t2s


def _as_pieces(x) -> tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _merged_gemm(x, *kernels: torch.Tensor) -> list[torch.Tensor]:
    """x @ [k0 ‖ k1 ‖ …] reading x once; kernels are [in, out] slices.
    Returns the column blocks in x's dtype."""
    pieces = _as_pieces(x)
    w = torch.cat(kernels, dim=1) if len(kernels) > 1 else kernels[0]
    z, row = None, 0
    for p in pieces:
        c = p.shape[-1]
        zz = stack_gemm(p, w[row : row + c])
        z = zz if z is None else z + zz
        row += c
    z = z.to(pieces[0].dtype)
    return list(torch.split(z, [k.shape[1] for k in kernels], dim=-1))


class _ValueHead(nn.Module):
    """Linear→BN→ReLU→Linear→BN→ReLU on [coupled ‖ self].  The first
    Linear's weight rows [:c_cross] apply to the coupled operand, rows
    [c_cross:] to the self operand; the parent runs it inside the merged
    GEMM.  Attribute names follow the JAX parameter paths."""

    def __init__(self, dv: int, c_cross: int, c_self: int, generator=None):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(c_cross + c_self, dv, generator=generator)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(dv)
        self.TorchLinear_1 = TorchLinear(dv, dv, generator=generator)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(dv)

    def first_kernel(self) -> torch.Tensor:
        return self.TorchLinear_0.weight.t()  # [c_cross + c_self, dv]

    def finish(self, z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.MaskedBatchNorm_0(z, mask))
        x = self.TorchLinear_1(x)
        return torch.relu(self.MaskedBatchNorm_1(x, mask))


class NodeEdgeInt(nn.Module):
    """Value-mode cross-simplex interaction, on dense-block levels
    ([G, S, C] features) or flat levels ([N, C] features)."""

    def __init__(self, c_t: int, c_s: int, dv: int, generator=None):
        super().__init__()
        self.c_t, self.c_s = c_t, c_s
        self.WV_Node = _ValueHead(dv, c_cross=c_s, c_self=c_t, generator=generator)
        self.WV_Edge = _ValueHead(dv, c_cross=c_t, c_self=c_s, generator=generator)

    def forward(self, x_t, x_s, level, deg: torch.Tensor):
        # deg carries the model's eps; zinc's is 0, so padded and isolated
        # nodes have deg 0 — guard the division (the numerator is 0 there)
        safe_deg = torch.where(deg > 0, deg, torch.ones_like(deg))
        c_t, c_s = self.c_t, self.c_s
        wn, we = self.WV_Node.first_kernel(), self.WV_Edge.first_kernel()
        zt_self, zt_cross = _merged_gemm(x_t, wn[c_s:], we[:c_t])
        zs_self, zs_cross = _merged_gemm(x_s, we[c_t:], wn[:c_s])
        s2t = abs_b1_s2t(level, zs_cross)
        s2t = s2t / safe_deg[..., None].to(s2t.dtype)
        t2s = abs_b1_t2s(level, zt_cross) / 2.0
        bn = self.WV_Node.TorchLinear_0.bias
        be = self.WV_Edge.TorchLinear_0.bias
        z_node = s2t + zt_self + bn.to(zt_self.dtype)
        z_edge = t2s + zs_self + be.to(zs_self.dtype)
        return (
            self.WV_Node.finish(z_node, level.node_mask),
            self.WV_Edge.finish(z_edge, level.edge_mask),
        )
