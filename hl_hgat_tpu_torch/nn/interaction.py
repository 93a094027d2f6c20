"""Node–edge interaction (MSI / NodeEdgeInt) in value and gate mode
(``hl_hgat_tpu/nn/interaction.py``).

    x_s2t = D⁻¹ · |B1| · x_s      x_t2s = |B1|ᵀ · x_t / 2

and two 2-layer MLPs (Linear→BN→ReLU ×2) on [x_s2t ‖ x_t] and
[x_t2s ‖ x_s] (reference lib/Hodge_Cheb_Conv.py:276-289).  As in the JAX
package the first Linear is applied before the boundary product
(project-then-couple: the coupling runs at width dv, not at the stack
width) and each wide operand is read by one merged GEMM shared by the two
heads.  The wide operands may be tuples of column pieces (the backbone's
dense-concat stacks); the GEMM then sums per-piece products in float32.

Gate mode (``only_att=True``, reference lib/Hodge_Cheb_Conv.py:61-120)
gives one scalar gate per node and per edge from queries and keys of
width dk: ``a_t = σ(((1−λ)·⟨q_{e→t}, k_t⟩ + λ·⟨q_t, k_t⟩)/√dk)`` and the
mirror for edges, σ a sigmoid or a ReLU.  The cross query is the coupled
edge query, formed at width dk (couple the projection, then add the bias).
The dot products are taken in the activation dtype and scaled in float32,
so the gates are float32 whatever the activations are.
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


def cross_simplex(x_t: torch.Tensor, x_s: torch.Tensor, level, deg: torch.Tensor):
    """The boundary couplings (x_s2t, x_t2s) = (D⁻¹·|B1|·x_s, |B1|ᵀ·x_t / 2)
    on either layout; ``deg`` already carries any epsilon, and a node of
    degree 0 (the zinc models add none) divides by 1 (its sum is 0)."""
    s2t = abs_b1_s2t(level, x_s)
    safe_deg = torch.where(deg > 0, deg, torch.ones_like(deg))
    return s2t / safe_deg[..., None].to(s2t.dtype), abs_b1_t2s(level, x_t) / 2.0


_SIGMA = {"sigmoid": torch.sigmoid, "relu": torch.relu}


class NodeEdgeInt(nn.Module):
    """Cross-simplex interaction on dense-block levels ([G, S, C] features)
    or flat levels ([N, C] features): value mode gives new (x_t, x_s) of
    width dv; ``only_att=True`` gives the float32 gates (a_t, a_s), one
    column each."""

    def __init__(
        self, c_t: int, c_s: int, dv: int = 64, generator=None, *,
        only_att: bool = False, dk: int = 32, sigma: str = "sigmoid", lam: float = 0.9,
    ):
        super().__init__()
        self.c_t, self.c_s = c_t, c_s
        self.only_att = only_att
        if only_att:
            if sigma not in _SIGMA:
                raise ValueError(f"unknown attention activation {sigma!r}")
            self.dk, self.sigma, self.lam = dk, sigma, lam
            for name, c in (("WQ_Node", c_t), ("WK_Node", c_t),
                            ("WQ_Edge", c_s), ("WK_Edge", c_s)):
                self.add_module(name, TorchLinear(c, dk, generator=generator))
            return
        self.WV_Node = _ValueHead(dv, c_cross=c_s, c_self=c_t, generator=generator)
        self.WV_Edge = _ValueHead(dv, c_cross=c_t, c_self=c_s, generator=generator)

    def forward(self, x_t, x_s, level, deg: torch.Tensor):
        # deg carries the model's eps; zinc's is 0, so padded and isolated
        # nodes have deg 0 — guard the division (the numerator is 0 there)
        safe_deg = torch.where(deg > 0, deg, torch.ones_like(deg))
        if self.only_att:
            return self._gates(x_t, x_s, level, safe_deg)
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

    def _gates(self, x_t, x_s, level, safe_deg):
        def kernel(name):
            return getattr(self, name).weight.t()

        def bias(name, like):
            return getattr(self, name).bias.to(like.dtype)

        # one merged GEMM per wide operand; the pre-bias query of each side
        # also feeds the other side's coupled query
        qn_pre, kn_pre = _merged_gemm(x_t, kernel("WQ_Node"), kernel("WK_Node"))
        qe_pre, ke_pre = _merged_gemm(x_s, kernel("WQ_Edge"), kernel("WK_Edge"))
        q_n = qn_pre + bias("WQ_Node", qn_pre)
        k_n = kn_pre + bias("WK_Node", kn_pre)
        q_e = qe_pre + bias("WQ_Edge", qe_pre)
        k_e = ke_pre + bias("WK_Edge", ke_pre)
        q_e2t = abs_b1_s2t(level, qe_pre)
        q_e2t = q_e2t / safe_deg[..., None].to(q_e2t.dtype)
        q_e2t = q_e2t + bias("WQ_Edge", q_e2t)
        q_n2s = abs_b1_t2s(level, qn_pre) / 2.0
        q_n2s = q_n2s + bias("WQ_Node", q_n2s)
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.dk), dtype=torch.float32))
        act, lam = _SIGMA[self.sigma], self.lam

        def gate(q_cross, q_self, k):
            logit = ((1.0 - lam) * (q_cross * k).sum(-1, keepdim=True)
                     + lam * (q_self * k).sum(-1, keepdim=True))
            return act(logit.float() * scale.to(logit.device))

        return gate(q_e2t, q_n, k_n), gate(q_n2s, q_e, k_e)


# The reference ships the same module under two names
# (lib/Hodge_Cheb_Conv.py:61 `MSI`, :255 `NodeEdgeInt`).
MSI = NodeEdgeInt
