"""The port's pooled and gated family against fixtures produced by the
reference code (``tests/golden/reference/*.npz``), as
``tests/test_reference_parity.py`` holds the JAX modules: the gate-mode MSI
(sigmoid and ReLU), SAPool, the zinc attpool and poolint3 models, the
pepfunc and CIFAR10-SP pyr and attpool models, and the zinc attpool
gradient.  The reference state dicts reach the port through the JAX
package's importer table and ``weights.from_flax_variables``; the pyramids
come from the port's own MLGC, held to the fixtures' cluster assignments.
Models run on the flat layout, as the fixtures were made, and on the packed
dense layout.  Tolerances are the JAX tests': rtol 1e-4 / atol 1e-5 for
layers, rtol 1e-4 / atol 1e-4 for models, rtol 2e-3 / atol 1e-5 for the
gradient.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.batch import ComplexLevel, CooMatrix, PoolMap
from hl_hgat_tpu_torch.complex.build import build_complex, collate
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt
from hl_hgat_tpu_torch.nn.pool import sapool_scatter
from hl_hgat_tpu_torch.train.losses import l1_loss
from hl_hgat_tpu_torch.utils.torch_import import _translate_hgcnn
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

FIX_DIR = os.path.join(os.path.dirname(__file__), "golden", "reference")
LAYER = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=1e-5)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIX_DIR), reason="reference fixtures not generated")


def _load(name):
    with np.load(os.path.join(FIX_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _prefixed(fx, prefix):
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def _level(edge_index, n, e, deg=None):
    if deg is None:
        deg = np.zeros(n, np.float32)
        np.add.at(deg, edge_index[0], 1.0)
        np.add.at(deg, edge_index[1], 1.0)
    dummy = lambda size: CooMatrix(  # noqa: E731
        rows=torch.zeros(1, dtype=torch.int32), cols=torch.zeros(1, dtype=torch.int32),
        vals=torch.zeros(1), shape=(size, size), symmetric=True)
    return ComplexLevel(
        src=torch.from_numpy(edge_index[0].astype(np.int32)),
        dst=torch.from_numpy(edge_index[1].astype(np.int32)),
        node_mask=torch.ones(n), edge_mask=torch.ones(e),
        n_id=torch.zeros(n, dtype=torch.int32), s_id=torch.zeros(e, dtype=torch.int32),
        l0=dummy(n), l1=dummy(e), deg=torch.from_numpy(np.asarray(deg, np.float32)),
        num_graphs=1)


def _gate_module(sd, c_t, c_s, sigma, lam):
    msi = NodeEdgeInt(c_t, c_s, only_att=True, dk=4, sigma=sigma, lam=lam)
    msi.load_state_dict({f"{name}.{leaf}": torch.from_numpy(sd[f"{name}.{leaf}"])
                         for name in ("WQ_Node", "WK_Node", "WQ_Edge", "WK_Edge")
                         for leaf in ("weight", "bias")})
    return msi


@pytest.mark.parametrize("name,sigma", [("msi_att_sigmoid", "sigmoid"), ("msi_att_relu", "relu")])
def test_gate_mode_msi_matches_reference(name, sigma):
    fx = _load(name)
    x_t, x_s = fx["x_t"], fx["x_s"]
    level = _level(fx["edge_index"], x_t.shape[0], x_s.shape[0])
    msi = _gate_module(_prefixed(fx, "sd/"), x_t.shape[1], x_s.shape[1], sigma, float(fx["lam"]))
    with torch.no_grad():
        a_t, a_s = msi(torch.from_numpy(x_t), torch.from_numpy(x_s), level,
                       torch.from_numpy(fx["deg"]))
    np.testing.assert_allclose(a_t.numpy(), fx["a_t"], **LAYER)
    np.testing.assert_allclose(a_s.numpy(), fx["a_s"], **LAYER)


def test_sapool_matches_reference():
    fx = _load("sapool")
    sd = {k.replace("NEAtt.", ""): v for k, v in _prefixed(fx, "sd/").items()}
    x_t, x_s = fx["x_t"], fx["x_s"]
    n, e = x_t.shape[0], x_s.shape[0]
    level = _level(fx["edge_index"], n, e, deg=fx["deg"])
    msi = _gate_module(sd, x_t.shape[1], x_s.shape[1], "sigmoid", 0.9)
    with torch.no_grad():
        a_t, a_s = msi(torch.from_numpy(x_t), torch.from_numpy(x_s), level,
                       torch.from_numpy(fx["deg"]))
    np.testing.assert_allclose(a_t.numpy(), fx["att_t"], **LAYER)
    np.testing.assert_allclose(a_s.numpy(), fx["att_s"], **LAYER)
    # deleted edges carry inf in the reference: here the coarse dump slot
    c_node = fx["c_node"].reshape(-1)
    c_edge = fx["c_edge"].reshape(-1)
    ce = fx["coarse_edge_index"]
    e_c = ce.shape[1]
    pool = PoolMap(pos_t=torch.from_numpy(c_node.astype(np.int32)),
                   pos_s=torch.from_numpy(np.where(np.isinf(c_edge), e_c, c_edge).astype(np.int32)))
    coarse = _level(ce, int(c_node.max()) + 1, e_c)
    with torch.no_grad():
        out_t, out_s = sapool_scatter(torch.from_numpy(x_t) * a_t, torch.from_numpy(x_s) * a_s,
                                      pool, level, coarse)
    np.testing.assert_allclose(out_t.numpy(), fx["out_t"], **LAYER)
    np.testing.assert_allclose(out_s.numpy(), fx["out_s"], **LAYER)


def _split_graphs(fx, prefix="in/"):
    n_off = np.concatenate([[0], np.cumsum(fx["num_node1"].astype(int))])
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    ei = fx[f"{prefix}edge_index"]
    out = []
    for g in range(len(n_off) - 1):
        cols = (ei[0] >= n_off[g]) & (ei[0] < n_off[g + 1])
        out.append(dict(edge_index=ei[:, cols] - n_off[g], n=int(n_off[g + 1] - n_off[g]),
                        x_t=fx[f"{prefix}x_t"][n_off[g]:n_off[g + 1]],
                        x_s=fx[f"{prefix}x_s"][e_off[g]:e_off[g + 1]]))
    return out


def _samples(fx, pooled):
    """Per-graph samples; with ``pooled`` one MLGC level below each, whose
    assignment must equal the reference's (x_t / x_s column 0, deleted
    edges as inf), then that column is dropped."""
    samples = []
    for g in _split_graphs(fx):
        if not pooled:
            samples.append(build_complex(g["edge_index"], g["n"], x_t=g["x_t"], x_s=g["x_s"],
                                         y=np.zeros(1)))
            continue
        s = build_complex(g["edge_index"], g["n"], x_t=g["x_t"][:, 1:], x_s=g["x_s"][:, 1:],
                          y=np.zeros(1))
        levels, pools = build_pyramid(list(s.levels), 1)
        c_node, c_edge = pools[0]
        np.testing.assert_array_equal(c_node, g["x_t"][:, 0].astype(np.int64))
        np.testing.assert_array_equal(np.where(c_edge < 0, np.inf, c_edge.astype(np.float64)),
                                      g["x_s"][:, 0].astype(np.float64))
        samples.append(dataclasses.replace(s, levels=levels, pools=pools))
    return samples


def _batch(samples, layout):
    if layout == "flat":
        return collate(samples, multiple=1).to("cpu")
    return collate_dense_packed(samples).to("cpu")


def _model(fx, cfg, samples, mlp_channels, num_classes):
    variables = {"params": {}, "batch_stats": {}}
    entries, _ = _translate_hgcnn(_prefixed(fx, "sd/"), head="graph")
    for (col, path), val in entries.items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    model = HLHGCNNGraph(cfg, samples[0].x_t.shape[1], samples[0].x_s.shape[1],
                         mlp_channels=mlp_channels, num_classes=num_classes)
    model.load_state_dict(from_flax_variables(variables))
    return model


_ATTPOOL = dict(pool_locs=(0,), att_dk=32)
MODELS = {
    # name: (pooled, backbone config, MLP, classes), the JAX tests' configurations
    "model_zinc_attpool": (True, dict(k=2, init_k=2, deg_eps=0.0, att_sigma="relu",
                                      att_lam=0.9, gate_input="last", gate_target="last",
                                      **_ATTPOOL), (), 1),
    "model_zinc_poolint3": (False, dict(k=2, init_k=2, deg_eps=0.0, msi_per_layer=False,
                                        stack_concat="layer"), (8,), 1),
    "model_cifar_attpool": (True, dict(k=2, init_k=1, deg_eps=1e-6, att_sigma="relu",
                                       att_lam=0.5, gate_input="last", gate_target="last",
                                       max_normalize_gates=True, **_ATTPOOL), (8,), 10),
    "model_pepfunc_attpool": (True, dict(k=2, init_k=1, deg_eps=1e-6, att_locs=(0, 1),
                                         att_sigma="sigmoid", att_lam=0.5, gate_input="stack",
                                         gate_target="stack", **_ATTPOOL), (8,), 10),
    "model_pepfunc_attpool_lib": (True, dict(k=2, init_k=1, deg_eps=1e-6, att_sigma="sigmoid",
                                             att_lam=0.9, gate_input="stack",
                                             gate_target="stack", **_ATTPOOL), (8,), 10),
    "model_cifar_pyr": (False, dict(k=2, init_k=1, deg_eps=1e-6), (8,), 10),
    "model_pepfunc_pyr": (False, dict(k=2, init_k=2, deg_eps=1e-6), (8,), 10),
}


@pytest.mark.parametrize("layout", ["flat", "dense"])
@pytest.mark.parametrize("name", list(MODELS))
def test_pooled_family_model_matches_reference(name, layout):
    pooled, kw, mlp, classes = MODELS[name]
    fx = _load(name)
    samples = _samples(fx, pooled)
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), **kw)
    model = _model(fx, cfg, samples, mlp, classes).eval()
    with torch.no_grad():
        out = model(_batch(samples, layout))
    np.testing.assert_allclose(out.numpy(), fx["out"], **MODEL)


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_grad_zinc_attpool_matches_reference(layout):
    """Train mode through the pool: the loss and every gradient.  The gates
    multiply the last outputs, which the pool never reads, so the reference
    has no gradient for the NEAtt parameters and the port none either."""
    fx = _load("grad_zinc_attpool")
    samples = _samples(fx, True)
    pooled, kw, mlp, classes = MODELS["model_zinc_attpool"]
    model = _model(fx, BackboneConfig(channels=(2, 2), filters=(8, 16), **kw), samples, mlp,
                   classes).train()
    loss = l1_loss(model(_batch(samples, layout)).reshape(-1, 1),
                   torch.from_numpy(fx["y"]).reshape(-1, 1))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(fx["loss"]), rel=1e-5)
    entries, _ = _translate_hgcnn(_prefixed(fx, "gd/"), head="graph")
    ref = {path: v for (col, path), v in entries.items() if col == "params"}
    named = dict(model.named_parameters())
    dead = {n for n, p in named.items() if p.grad is None}
    assert dead and all(n.startswith("backbone.NEAtt") for n in dead), dead
    got = to_flax_paths(model, {n: p.grad for n, p in named.items() if n not in dead})
    assert set(got) == set(ref)
    for path in sorted(ref):
        np.testing.assert_allclose(got[path], ref[path], err_msg="/".join(path), **GRAD)
