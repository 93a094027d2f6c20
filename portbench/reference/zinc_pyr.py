"""Plain reference of ``zinc_pyr`` (reference main_zinc_HL_HGCNN_dense_int3_pyr.py
with lib/Hodge_ST_Model.py's dense-int3 trunk): a shared 28-row embedding
replaces the id column of the atoms and of the bonds; an init Laguerre conv
pair (K = 1); per block i of ``filters[i]`` channels, ``channels[i]`` layers
of MSI → Laguerre conv pair (K) → BN → ReLU, each output concatenated onto
the node and edge stacks; the per-graph mean of the last edge and node
features → MLP (Linear → BN → ReLU) → one output.  L1 loss, Adam with L2.

Parameter names are the state-dict names of the port's model, so one set of
weights made by the benchmark loads into both; nothing here imports the
port.  The zinc loop adds no degree epsilon (reference lib/Hodge_ST_Model.py:
624).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import ops
from portbench.reference.ops import Level, Precision


def param_spec(model: dict) -> list[tuple[str, tuple, tuple[float, float]]]:
    """(name, shape, (centre, half width)) of every parameter and BN buffer;
    each is drawn uniformly from centre ± half width."""
    filters, channels, k = model["filters"], model["channels"], model["k"]
    f0, keig = filters[0], model["keig"]
    embed_dim = f0 - keig
    spec = [("node_embedding.weight", (model["embed_num"], embed_dim),
             (0.0, (3.0 / embed_dim) ** 0.5))]
    spec += _conv("backbone.init_node", embed_dim + keig, f0, model["init_k"])
    spec += _conv("backbone.init_edge", embed_dim + keig, f0, model["init_k"])
    stack = f0
    for i, width in enumerate(filters):
        for j in range(channels[i]):
            for head in ("WV_Node", "WV_Edge"):
                spec += _value_head(f"backbone.NEInt{i}{j}.{head}", 2 * stack, width)
            spec += _conv(f"backbone.NEConv{i}{j}.node", width, width, k)
            spec += _conv(f"backbone.NEConv{i}{j}.edge", width, width, k)
            stack += width
    width = 2 * filters[-1]
    for i, out in enumerate(model["mlp_channels"]):
        spec += _linear(f"head.mlp{i}_lin", width, out) + _bn(f"head.mlp{i}_bn", out)
        width = out
    return spec + _linear("head.out", width, 1)


def _linear(name, fan_in, out):
    h = fan_in ** -0.5
    return [(name + ".weight", (out, fan_in), (0.0, h)), (name + ".bias", (out,), (0.0, h))]


def _bn(name, c):
    return [(name + ".weight", (c,), (1.0, 0.1)), (name + ".bias", (c,), (0.0, 0.1)),
            (name + ".running_mean", (c,), (0.0, 0.1)),
            (name + ".running_var", (c,), (1.0, 0.25))]


def _conv(name, c, f, k):
    glorot = (6.0 / (c + f)) ** 0.5
    return ([(name + ".conv.weight", (k, c, f), (0.0, glorot)),
             (name + ".conv.bias", (f,), (0.0, c ** -0.5))] + _bn(name + ".bn", f))


def _value_head(name, c_in, dv):
    return (_linear(name + ".TorchLinear_0", c_in, dv) + _bn(name + ".MaskedBatchNorm_0", dv)
            + _linear(name + ".TorchLinear_1", dv, dv) + _bn(name + ".MaskedBatchNorm_1", dv))


def make_batch(mols: list[dict], device, dtype=torch.float64) -> dict:
    """The flat reference batch of raw molecules: every graph's nodes and
    edges concatenated, its operators' spectral scales worked out anew."""
    n = np.array([m["n"] for m in mols])
    e = np.array([m["src"].shape[0] for m in mols])
    off = np.concatenate([[0], np.cumsum(n)[:-1]])
    src = np.concatenate([m["src"] + o for m, o in zip(mols, off)])
    dst = np.concatenate([m["dst"] + o for m, o in zip(mols, off)])
    g = len(mols)

    def dev(a, dt=None):
        return torch.as_tensor(a, device=device, dtype=dt)

    node_graph = dev(np.repeat(np.arange(g), n), torch.long)
    edge_graph = dev(np.repeat(np.arange(g), e), torch.long)
    src_t, dst_t = dev(src, torch.long), dev(dst, torch.long)
    scale = ops.spectral_scale(src_t, dst_t, node_graph, g, int(n.max()))
    return dict(
        level=Level(src_t, dst_t, int(n.sum()), scale[node_graph][:, None],
                    scale[edge_graph][:, None]),
        x_t=dev(np.concatenate([m["x_t"] for m in mols]), dtype),
        x_s=dev(np.concatenate([m["x_s"] for m in mols]), dtype),
        y=dev(np.concatenate([m["y"] for m in mols]), dtype),
        node_graph=node_graph, edge_graph=edge_graph, num_graphs=g)


def _graph_mean(x, graph, g):
    total = x.new_zeros(g, x.shape[-1]).index_add(0, graph, x)
    count = torch.zeros(g, dtype=x.dtype, device=x.device).index_add(
        0, graph, torch.ones_like(graph, dtype=x.dtype))
    return total / count[:, None]


def forward(p: dict, batch: dict, model: dict, *, train: bool, prec: Precision):
    """[num_graphs] predictions."""
    lvl = batch["level"]
    table = p["node_embedding.weight"]
    x_t = torch.cat([table[batch["x_t"][:, 0].long()], batch["x_t"][:, 1:]], dim=-1)
    x_s = torch.cat([table[batch["x_s"][:, 0].long()], batch["x_s"][:, 1:]], dim=-1)
    relu = torch.relu
    x_t = ops.conv_bn_act(x_t, lvl.l0, p, "backbone.init_node", relu, train, prec)
    x_s = ops.conv_bn_act(x_s, lvl.l1, p, "backbone.init_edge", relu, train, prec)
    stack_t, stack_s = x_t, x_s
    for i in range(len(model["filters"])):
        for j in range(model["channels"][i]):
            m_t, m_s = ops.msi(stack_t, stack_s, lvl, p, f"backbone.NEInt{i}{j}", train, prec)
            x_t = ops.conv_bn_act(m_t, lvl.l0, p, f"backbone.NEConv{i}{j}.node", relu, train,
                                  prec)
            x_s = ops.conv_bn_act(m_s, lvl.l1, p, f"backbone.NEConv{i}{j}.edge", relu, train,
                                  prec)
            stack_t = torch.cat([stack_t, x_t], dim=-1)
            stack_s = torch.cat([stack_s, x_s], dim=-1)
    g = batch["num_graphs"]
    h = torch.cat([_graph_mean(x_s, batch["edge_graph"], g),
                   _graph_mean(x_t, batch["node_graph"], g)], dim=-1)
    for i in range(len(model["mlp_channels"])):
        h = relu(ops.batch_norm(ops.linear(h, p, f"head.mlp{i}_lin", prec), p,
                                f"head.mlp{i}_bn", train))
    return ops.linear(h, p, "head.out", prec).reshape(-1)


def loss(pred, y):
    """L1 against the targets (reference main_zinc...py:213)."""
    return (pred - y).abs().mean()


def shape_of(mols: list[dict]) -> dict:
    """What the work of a batch depends on: graphs, nodes, edges and the
    nonzeros of every graph's L0 and L1."""
    nnz0 = nnz1 = 0
    for m in mols:
        e = m["src"].shape[0]
        deg = np.bincount(m["src"], minlength=m["n"]) + np.bincount(m["dst"], minlength=m["n"])
        nnz0 += m["n"] + 2 * e
        nnz1 += e + int((deg * (deg - 1)).sum())
    return dict(graphs=len(mols), nodes=sum(m["n"] for m in mols),
                edges=sum(m["src"].shape[0] for m in mols), nnz0=nnz0, nnz1=nnz1)


def products(model: dict, shape: dict) -> list[tuple]:
    """Every matrix product of one forward, as (M, K, N, dx, dw): an [M, K] by
    [K, N] product, and whether the backward forms the gradient of its
    input (dx) and of its weight (dw)."""
    rows = (shape["nodes"], shape["edges"])
    f0, k = model["filters"][0], model["k"]
    c_in = f0  # embed_dim + keig
    out = [(r, c_in, f0, True, True) for r in rows for _ in range(model["init_k"])]
    stack = f0
    for i, w in enumerate(model["filters"]):
        for _ in range(model["channels"][i]):
            for r in rows:
                out += [(r, 2 * stack, w, True, True), (r, w, w, True, True)]
                out += [(r, w, w, True, True)] * k
            stack += w
    width = 2 * model["filters"][-1]
    for m in model["mlp_channels"]:
        out.append((shape["graphs"], width, m, True, True))
        width = m
    return out + [(shape["graphs"], width, 1, True, True)]


def operator_products(model: dict, shape: dict) -> list[tuple]:
    """Every application of L0 or L1 in one forward, as (nnz, columns, dx)."""
    out = []
    for nnz in (shape["nnz0"], shape["nnz1"]):
        out += [(nnz, model["filters"][0], True)] * (model["init_k"] - 1)
        for i, w in enumerate(model["filters"]):
            out += [(nnz, w, True)] * ((model["k"] - 1) * model["channels"][i])
    return out
