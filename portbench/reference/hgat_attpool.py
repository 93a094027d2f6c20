"""Plain reference of ``hgat_attpool`` (HL-HGAT-DEMO lib/Hodge_Cheb_Conv.py:
250-399, OHBM_DEMO.ipynb cells 36 and 40) on subjects that share the
Shen-268 skeleton.

Each subject's time courses are z-scored by one mean and one unbiased std,
its Pearson FC at the skeleton's edges is the edge input (reference
lib/Hodge_Dataset.py:110-145), and its score is z-scored by the DEMO's mean
and std.  Inception1D (stem, two inception stages with BN and LeakyReLU,
max and mean over time) embeds the nodes; an init Laguerre conv pair (K) →
BN → LeakyReLU; per block, MSI → Laguerre conv pair layers on the stacks,
then, after the pooled blocks, sigmoid gates from the stacks multiply the
stacks, which are mean-pooled onto the next level of the reference run's
MLGC pyramid; K = 1 convs read one value per simplex of the last level,
and the flattened [edges ‖ nodes] vector → MLP → one output.  MSE loss,
Adam with L2.  Parameter names are the port's state-dict names; nothing
here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference import ops
from portbench.reference.ops import Level, Precision
from portbench.reference.zinc_pyr import _bn, _conv, _linear, _value_head

Y_MEAN, Y_STD = 95.1377, 7.3


def param_spec(model: dict, sizes: dict) -> list[tuple[str, tuple, tuple[float, float]]]:
    """As ``zinc_pyr.param_spec``; ``sizes`` gives the last level's node and
    edge counts (the head's input width)."""
    c, nc = 64, 8
    spec = []
    for name, c_in, c_out, k in (("embedding", 1, c, 5), ("channel1_1", c, c // 4, 1),
                                 ("channel2_1", c, c // 2, 3), ("channel3_1", c, c // 4, 5),
                                 ("channel1_2", c, nc, 1), ("channel2_2", c, 2 * nc, 3),
                                 ("channel3_2", c, nc, 5)):
        h = (c_in * k) ** -0.5
        spec += [(f"node_embedding.{name}.weight", (c_out, c_in, k), (0.0, h)),
                 (f"node_embedding.{name}.bias", (c_out,), (0.0, h))]
    spec += _bn("node_embedding.bn1", c) + _bn("node_embedding.bn2", 4 * nc)
    filters, channels, k = model["filters"], model["channels"], model["k"]
    f0 = filters[0]
    spec += _conv("backbone.init_node", 8 * nc, f0, k) + _conv("backbone.init_edge", 1, f0, k)
    stack = f0
    for i, width in enumerate(filters):
        for j in range(channels[i]):
            for head in ("WV_Node", "WV_Edge"):
                spec += _value_head(f"backbone.NEInt{i}{j}.{head}", 2 * stack, width)
            spec += _conv(f"backbone.NEConv{i}{j}.node", width, width, k)
            spec += _conv(f"backbone.NEConv{i}{j}.edge", width, width, k)
            stack += width
        if i < model["pool_num"]:
            for name in ("WQ_Node", "WK_Node", "WQ_Edge", "WK_Edge"):
                spec += _linear(f"backbone.NEAtt{i}.{name}", stack, model["att_dk"])
    last = filters[-1]
    spec += [("readout_node.weight", (1, last, 1), (0.0, (6.0 / (last + 1)) ** 0.5)),
             ("readout_node.bias", (1,), (0.0, last ** -0.5)),
             ("readout_edge.weight", (1, last, 1), (0.0, (6.0 / (last + 1)) ** 0.5)),
             ("readout_edge.bias", (1,), (0.0, last ** -0.5))]
    width = sizes["nodes"] + sizes["edges"]
    for i, out in enumerate(model["mlp_channels"]):
        spec += _linear(f"head.mlp{i}_lin", width, out) + _bn(f"head.mlp{i}_bn", out)
        width = out
    return spec + _linear("head.out", width, 1)


def pyramid(skel: dict, device, pool_num: int, deg_eps: float) -> dict:
    """The levels (edges, spectral scales, degrees) and pooling assignments of
    the reference run's pyramid, worked out from its edge lists."""
    edges = [(skel["skeleton_src"], skel["skeleton_dst"])]
    edges += [tuple(skel[f"l{i}_edge_index"]) for i in range(1, pool_num + 1)]
    levels = []
    for (src, dst), n in zip(edges, skel["num_node"][: pool_num + 1]):
        src_t = torch.as_tensor(np.asarray(src), dtype=torch.long, device=device)
        dst_t = torch.as_tensor(np.asarray(dst), dtype=torch.long, device=device)
        zeros = torch.zeros(int(n), dtype=torch.long, device=device)
        scale = ops.spectral_scale(src_t, dst_t, zeros, 1, int(n))[0]
        levels.append(Level(src_t, dst_t, int(n), scale.expand(int(n), 1),
                            scale.expand(src_t.shape[0], 1), deg_eps))

    def assign(key):
        a = np.asarray(skel[key], np.float64).reshape(-1)
        return torch.as_tensor(np.where(np.isfinite(a), a, -1).astype(np.int64), device=device)

    pools = [(assign(f"pos_t{i}"), assign(f"pos_s{i}")) for i in range(pool_num)]
    return dict(levels=levels, pools=pools)


def make_batch(series: np.ndarray, scores: np.ndarray, skel: dict, device,
               dtype=torch.float64) -> dict:
    """Subjects' inputs worked out from their raw series [G, R, T] and scores."""
    ts = torch.as_tensor(np.asarray(series), dtype=torch.float64, device=device)
    flat = ts.reshape(ts.shape[0], -1)
    ts = (ts - flat.mean(1)[:, None, None]) / flat.std(1, unbiased=True)[:, None, None]
    centred = ts - ts.mean(-1, keepdim=True)
    unit = centred / centred.norm(dim=-1, keepdim=True)
    src = torch.as_tensor(skel["skeleton_src"], dtype=torch.long, device=device)
    dst = torch.as_tensor(skel["skeleton_dst"], dtype=torch.long, device=device)
    fc = (unit[:, src] * unit[:, dst]).sum(-1, keepdim=True)
    y = (torch.as_tensor(np.asarray(scores), dtype=torch.float64, device=device)
         - Y_MEAN) / Y_STD
    return dict(x_t=ts.to(dtype), x_s=fc.to(dtype), y=y.to(dtype))


def inception(p, x, train, prec: Precision):
    """Inception1D with the DEMO's max-and-mean readout: x [N, T] → [N, 64]."""
    def conv(z, name, pad):
        pre = f"node_embedding.{name}"
        return prec.conv1d(z, p[pre + ".weight"], p[pre + ".bias"], pad)

    def bn_act(z, name):
        z = ops.batch_norm(z.transpose(1, 2), p, f"node_embedding.{name}", train)
        return F.leaky_relu(z.transpose(1, 2), 0.1)

    z = conv(x[:, None, :], "embedding", 2)
    z = torch.cat([conv(z, "channel1_1", 0), conv(z, "channel2_1", 1),
                   conv(z, "channel3_1", 2)], dim=1)
    z = F.max_pool1d(bn_act(z, "bn1"), 3, stride=2, padding=1)
    z = torch.cat([conv(z, "channel1_2", 0), conv(z, "channel2_2", 1),
                   conv(z, "channel3_2", 2)], dim=1)
    z = bn_act(z, "bn2")
    return torch.cat([z.amax(-1), z.mean(-1)], dim=-1)


def forward(p: dict, batch: dict, pyr: dict, model: dict, *, train: bool, prec: Precision):
    """(pred [G], node gates [G, n0], edge gates [G, e0]) of the first pooled
    block."""
    def act(z):
        return F.leaky_relu(z, 0.1)

    g, rois, t_len = batch["x_t"].shape
    lvl = pyr["levels"][0]
    x_t = inception(p, batch["x_t"].reshape(g * rois, t_len), train, prec).reshape(g, rois, -1)
    x_t = ops.conv_bn_act(x_t, lvl.l0, p, "backbone.init_node", act, train, prec)
    x_s = ops.conv_bn_act(batch["x_s"], lvl.l1, p, "backbone.init_edge", act, train, prec)
    stack_t, stack_s = x_t, x_s
    first = None
    for i in range(len(model["filters"])):
        for j in range(model["channels"][i]):
            m_t, m_s = ops.msi(stack_t, stack_s, lvl, p, f"backbone.NEInt{i}{j}", train, prec)
            x_t = ops.conv_bn_act(m_t, lvl.l0, p, f"backbone.NEConv{i}{j}.node", act, train,
                                  prec)
            x_s = ops.conv_bn_act(m_s, lvl.l1, p, f"backbone.NEConv{i}{j}.edge", act, train,
                                  prec)
            stack_t = torch.cat([stack_t, x_t], dim=-1)
            stack_s = torch.cat([stack_s, x_s], dim=-1)
        if i < model["pool_num"]:
            a_t, a_s = ops.gates(stack_t, stack_s, lvl, p, f"backbone.NEAtt{i}", prec,
                                 lam=model["att_lam"], dk=model["att_dk"])
            first = (a_t[..., 0], a_s[..., 0]) if first is None else first
            pos_t, pos_s = pyr["pools"][i]
            coarse = pyr["levels"][i + 1]
            stack_t = ops.pool_mean(stack_t * a_t, pos_t, coarse.n)
            stack_s = ops.pool_mean(stack_s * a_s, pos_s, coarse.e)
            lvl = coarse
    r_t = ops.laguerre(x_t, lvl.l0, p["readout_node.weight"], p["readout_node.bias"], prec)
    r_s = ops.laguerre(x_s, lvl.l1, p["readout_edge.weight"], p["readout_edge.bias"], prec)
    h = torch.cat([r_s[..., 0], r_t[..., 0]], dim=-1)
    for i in range(len(model["mlp_channels"])):
        h = act(ops.batch_norm(ops.linear(h, p, f"head.mlp{i}_lin", prec), p,
                               f"head.mlp{i}_bn", train))
    return ops.linear(h, p, "head.out", prec).reshape(-1), first[0], first[1]


def loss(pred, y):
    """MSE on the z-scored scores (OHBM_DEMO.ipynb cell 40)."""
    return ((pred - y) ** 2).mean()


def shape_of(subjects: int, t_len: int, skel: dict, pool_num: int) -> dict:
    """Subjects, time points, and per level its nodes, edges and the nonzeros
    of its L0 and L1 (one skeleton for every subject)."""
    levels = []
    edges = [(skel["skeleton_src"], skel["skeleton_dst"])]
    edges += [tuple(skel[f"l{i}_edge_index"]) for i in range(1, pool_num + 1)]
    for (src, dst), n in zip(edges, skel["num_node"][: pool_num + 1]):
        n = int(n)
        deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
        e = int(len(src))
        levels.append(dict(nodes=n, edges=e, nnz0=n + 2 * e,
                           nnz1=e + int((deg * (deg - 1)).sum())))
    return dict(graphs=subjects, t_len=t_len, levels=levels)


def _conv_products(rows, t_len, c_in, outs, dx):
    """Conv1d channels of kernel sizes ``outs`` [(c_out, k)] as products."""
    return [(rows * t_len, c_in * k, c_out, dx, True) for c_out, k in outs]


def products(model: dict, shape: dict) -> list[tuple]:
    """As ``zinc_pyr.products``; a Conv1d counts as the product of its
    unfolded input [N·T, C_in·k] and its [C_in·k, C_out] weight."""
    g, t_len, lv = shape["graphs"], shape["t_len"], shape["levels"]
    rows = g * lv[0]["nodes"]
    t2 = (t_len - 1) // 2 + 1
    out = _conv_products(rows, t_len, 1, [(64, 5)], False)
    out += _conv_products(rows, t_len, 64, [(16, 1), (32, 3), (16, 5)], True)
    out += _conv_products(rows, t2, 64, [(8, 1), (16, 3), (8, 5)], True)
    f0, k, dk = model["filters"][0], model["k"], model["att_dk"]
    out += [(g * lv[0]["nodes"], 64, f0, True, True)] * k
    out += [(g * lv[0]["edges"], 1, f0, False, True)] * k
    stack, level = f0, 0
    for i, w in enumerate(model["filters"]):
        n, e = g * lv[level]["nodes"], g * lv[level]["edges"]
        for _ in range(model["channels"][i]):
            for r in (n, e):
                out += [(r, 2 * stack, w, True, True), (r, w, w, True, True)]
                out += [(r, w, w, True, True)] * k
            stack += w
        if i < model["pool_num"]:
            out += [(r, stack, dk, True, True) for r in (n, n, n, e, e, e)]
            level += 1
    last = model["filters"][-1]
    n, e = g * lv[level]["nodes"], g * lv[level]["edges"]
    out += [(n, last, 1, True, True), (e, last, 1, True, True)]
    width = lv[level]["nodes"] + lv[level]["edges"]
    for m in model["mlp_channels"]:
        out.append((g, width, m, True, True))
        width = m
    return out + [(g, width, 1, True, True)]


def operator_products(model: dict, shape: dict) -> list[tuple]:
    """As ``zinc_pyr.operator_products``: the skeleton's operators applied to
    every subject's columns."""
    g, lv, k = shape["graphs"], shape["levels"], model["k"]
    f0 = model["filters"][0]
    out = [(lv[0]["nnz0"], g * f0, True)] * (k - 1) + [(lv[0]["nnz1"], g * f0, False)] * (k - 1)
    level = 0
    for i, w in enumerate(model["filters"]):
        for key in ("nnz0", "nnz1"):
            out += [(lv[level][key], g * w, True)] * ((k - 1) * model["channels"][i])
        if i < model["pool_num"]:
            level += 1
    return out
