"""The plain math both reference models are made of (plain PyTorch).

Written from the published description (HL-HGAT, reference lib/
Hodge_Cheb_Conv.py and lib/Hodge_ST_Model.py), not from the port: graphs are
kept as edge lists and every operator is applied matrix-free,

    B1ᵀx = x[dst] − x[src]        B1·y = scatter(+y at dst, −y at src)
    L0 = 2·B1B1ᵀ/λmax              L1 = 2·B1ᵀB1/λmax        (per graph)
    |B1|·y = scatter(y at src and dst)      |B1|ᵀx = x[src] + x[dst],

so neither dense blocks, packing nor the port's kernels appear.  Features
carry their simplices on axis −2 ([rows, C], or [G, rows, C] for subjects
on one shared skeleton).  ``Precision`` sets the dtype and whether every
product rounds its operands to TF32 (10 mantissa bits), which is the
control's precision.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.nn import functional as F

BN_EPS = 1e-5


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a [..., K] @ b [K, N] with every product's operands rounded to TF32,
    the two of the backward included; float32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        db = torch.matmul(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return torch.matmul(g, b.t()), db


def _tf32_in(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 in the forward, the gradient passed through."""
    return t + (round_tf32(t) - t).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., K] @ b [K, N]."""
        return _TF32MatMul.apply(a, b) if self.tf32 else torch.matmul(a, b)

    def conv1d(self, x, w, b, padding):
        if self.tf32:
            x, w = _tf32_in(x), _tf32_in(w)
        return F.conv1d(x, w, b, padding=padding)


REFERENCE = Precision(torch.float64)
CONTROL = Precision(torch.float32, tf32=True)


class Level:
    """One level of a complex: canonical edges ``src``/``dst`` indexing the
    rows of axis −2, the per-row spectral scales 2/λmax of their graph
    (``scale_n`` [n, 1], ``scale_e`` [e, 1]) and the degrees [n, 1] (with
    the model's epsilon; 0 becomes 1)."""

    def __init__(self, src, dst, n: int, scale_n, scale_e, deg_eps: float = 0.0):
        self.src, self.dst, self.n = src, dst, n
        self.scale_n, self.scale_e = scale_n, scale_e
        deg = torch.zeros(n, dtype=scale_n.dtype, device=src.device)
        deg.index_add_(0, src, torch.ones_like(src, dtype=deg.dtype))
        deg.index_add_(0, dst, torch.ones_like(dst, dtype=deg.dtype))
        deg = deg + deg_eps
        self.deg = torch.where(deg > 0, deg, torch.ones_like(deg))[:, None]

    @property
    def e(self) -> int:
        return self.src.shape[0]

    def b1t(self, x):
        d = x.dim() - 2
        return x.index_select(d, self.dst) - x.index_select(d, self.src)

    def b1(self, y):
        d = y.dim() - 2
        shape = list(y.shape)
        shape[d] = self.n
        out = y.new_zeros(shape)
        return out.index_add(d, self.dst, y).index_add(d, self.src, -y)

    def l0(self, x):
        return self.scale_n.to(x.dtype) * self.b1(self.b1t(x))

    def l1(self, y):
        return self.scale_e.to(y.dtype) * self.b1t(self.b1(y))

    def s2t(self, y):
        """D⁻¹·|B1|·y."""
        d = y.dim() - 2
        shape = list(y.shape)
        shape[d] = self.n
        out = y.new_zeros(shape).index_add(d, self.dst, y).index_add(d, self.src, y)
        return out / self.deg.to(y.dtype)

    def t2s(self, x):
        """|B1|ᵀ·x / 2."""
        d = x.dim() - 2
        return (x.index_select(d, self.src) + x.index_select(d, self.dst)) / 2.0


def spectral_scale(src: torch.Tensor, dst: torch.Tensor, graph_of_node: torch.Tensor,
                   num_graphs: int, max_nodes: int, dtype=torch.float64) -> torch.Tensor:
    """2/λmax of each graph's L0 = B1B1ᵀ, from its dense L0 (float64 eigvalsh,
    one batched call): [num_graphs]."""
    dev = src.device
    first = torch.full((num_graphs,), src.numel() + graph_of_node.numel(), device=dev,
                       dtype=torch.long)
    node_ids = torch.arange(graph_of_node.numel(), device=dev)
    first = first.scatter_reduce(0, graph_of_node, node_ids, reduce="amin")
    local = node_ids - first[graph_of_node]
    lap = torch.zeros(num_graphs, max_nodes, max_nodes, dtype=torch.float64, device=dev)
    g = graph_of_node[src]
    a, b = local[src], local[dst]
    ones = torch.ones_like(a, dtype=torch.float64)
    lap.index_put_((g, a, a), ones, accumulate=True)
    lap.index_put_((g, b, b), ones, accumulate=True)
    lap.index_put_((g, a, b), -ones, accumulate=True)
    lap.index_put_((g, b, a), -ones, accumulate=True)
    lam = torch.linalg.eigvalsh(lap)[:, -1]
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    return (2.0 / lam).to(dtype)


def linear(x, p, name, prec: Precision):
    """torch.nn.Linear: weight [out, in], bias [out]."""
    return prec.mm(x, p[name + ".weight"].t()) + p[name + ".bias"]


def batch_norm(x, p, name, train: bool):
    """BatchNorm1d over every row of x (all axes but the last): batch
    statistics (biased variance) in training, running ones in eval."""
    if train:
        rows = x.reshape(-1, x.shape[-1])
        mean = rows.mean(0)
        var = rows.var(0, unbiased=False)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def laguerre(x, lap, weight, bias, prec: Precision):
    """Σ_k T_k(L)x·W_k + b with T0 = x, T1 = x − Lx and
    T_{k+1} = (−L·T_k + (2k+1)·T_k − k·T_{k−1}) / (k+1)
    (reference lib/Hodge_Cheb_Conv.py:494,507); weight [K, C, F]."""
    k = weight.shape[0]
    terms = [x]
    if k > 1:
        terms.append(x - lap(x))
    for j in range(1, k - 1):
        t, prev = terms[-1], terms[-2]
        terms.append((-lap(t) + (2 * j + 1) * t - j * prev) / (j + 1))
    out = bias
    for kk, t in enumerate(terms):
        out = out + prec.mm(t, weight[kk])
    return out


def conv_bn_act(x, lap, p, name, act, train, prec):
    """LaguerreConv → BN → activation (reference lib/Hodge_ST_Model.py:578-589)."""
    y = laguerre(x, lap, p[name + ".conv.weight"], p[name + ".conv.bias"], prec)
    return act(batch_norm(y, p, name + ".bn", train))


def msi(x_t, x_s, lvl: Level, p, name, train, prec):
    """The node–edge interaction (reference lib/Hodge_Cheb_Conv.py:276-289):
    Linear→BN→ReLU→Linear→BN→ReLU on [D⁻¹|B1|x_s ‖ x_t] and on
    [|B1|ᵀx_t/2 ‖ x_s]."""
    def head(z, hname):
        z = torch.relu(batch_norm(linear(z, p, hname + ".TorchLinear_0", prec), p,
                                  hname + ".MaskedBatchNorm_0", train))
        return torch.relu(batch_norm(linear(z, p, hname + ".TorchLinear_1", prec), p,
                                     hname + ".MaskedBatchNorm_1", train))

    node = head(torch.cat([lvl.s2t(x_s), x_t], dim=-1), name + ".WV_Node")
    edge = head(torch.cat([lvl.t2s(x_t), x_s], dim=-1), name + ".WV_Edge")
    return node, edge


def gates(x_t, x_s, lvl: Level, p, name, prec, *, lam: float, dk: int):
    """Sigmoid attention gates, one per node and per edge (reference
    lib/Hodge_Cheb_Conv.py:61-120): a_t = σ(((1−λ)⟨q_{e→t}, k_t⟩ +
    λ⟨q_t, k_t⟩)/√dk), q_{e→t} the query of the coupled edges, and the
    mirror for edges.  Returns ([.., n, 1], [.., e, 1])."""
    q_t = linear(x_t, p, name + ".WQ_Node", prec)
    k_t = linear(x_t, p, name + ".WK_Node", prec)
    q_s = linear(x_s, p, name + ".WQ_Edge", prec)
    k_s = linear(x_s, p, name + ".WK_Edge", prec)
    q_s2t = linear(lvl.s2t(x_s), p, name + ".WQ_Edge", prec)
    q_t2s = linear(lvl.t2s(x_t), p, name + ".WQ_Node", prec)
    scale = 1.0 / math.sqrt(dk)

    def gate(q_cross, q_self, k):
        logit = ((1.0 - lam) * (q_cross * k).sum(-1, keepdim=True)
                 + lam * (q_self * k).sum(-1, keepdim=True))
        return torch.sigmoid(logit * scale)

    return gate(q_s2t, q_t, k_t), gate(q_t2s, q_s, k_s)


def pool_mean(x, assign, n_coarse: int):
    """Each coarse row the mean of the fine rows assigned to it (assign < 0:
    dropped) along axis −2."""
    d = x.dim() - 2
    keep = torch.nonzero(assign >= 0).reshape(-1)
    target = assign[keep]
    shape = list(x.shape)
    shape[d] = n_coarse
    total = x.new_zeros(shape).index_add(d, target, x.index_select(d, keep))
    count = torch.zeros(n_coarse, dtype=x.dtype, device=x.device).index_add(
        0, target, torch.ones_like(target, dtype=x.dtype))
    return total / count.clamp(min=1.0)[:, None]


def adam_l2_step(params: dict, grads: dict, state: dict, step: int, *, lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> dict:
    """One torch-style Adam step with L2 added to the gradient before the
    moments (reference main_zinc...py:209); returns the gradients as the
    update read them (with the L2 term).  ``state`` holds m and v."""
    seen = {}
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] + weight_decay * p
            seen[name] = g
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** step)) + eps
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
    return seen
