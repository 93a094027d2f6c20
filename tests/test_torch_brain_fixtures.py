"""The port's brain family against fixtures produced by the reference code
(``tests/golden/reference/*.npz``), as ``tests/test_reference_parity.py``
and ``tests/test_brain_real.py`` hold the JAX modules: the ABCD model with
one and with two pools, ``HL_filter`` dense and plain, the Chebyshev conv,
``fc2mask`` on the real group FC and on a stack, and the Shen-268 pyramid
rebuilt from the skeleton arrays of ``model_hgat_attpool``.  The reference
state dicts reach the port through the JAX package's importer table and
``weights.from_flax_variables``.  Tolerances are the JAX tests': rtol 1e-4 /
atol 1e-5 for layers, rtol 1e-4 / atol 1e-4 for models; masks and the
pyramid exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hl_hgat_tpu.utils.torch_import import _translate_hgcnn
from hl_hgat_tpu_torch.complex.batch import ComplexLevel, CooMatrix
from hl_hgat_tpu_torch.complex.build import build_complex, collate
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid
from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
from hl_hgat_tpu_torch.data.brain import brain_pyramid, real_skeleton
from hl_hgat_tpu_torch.data.datasets import fc2mask
from hl_hgat_tpu_torch.models.abcd import HLHGCNNAbcd
from hl_hgat_tpu_torch.models.backbone import BackboneConfig
from hl_hgat_tpu_torch.nn.blocks import HLFilter
from hl_hgat_tpu_torch.nn.conv import ChebConv
from hl_hgat_tpu_torch.weights import from_flax_variables

FIX_DIR = os.path.join(os.path.dirname(__file__), "golden", "reference")
LAYER = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIX_DIR), reason="reference fixtures not generated")


def _load(name):
    with np.load(os.path.join(FIX_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _prefixed(fx, prefix):
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def _variables(entries):
    variables = {"params": {}, "batch_stats": {}}
    for (col, path), val in entries.items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return variables


def _coo(ei, vals, n):
    return CooMatrix(rows=torch.from_numpy(ei[0].astype(np.int32)),
                     cols=torch.from_numpy(ei[1].astype(np.int32)),
                     vals=torch.from_numpy(np.asarray(vals, np.float32)), shape=(n, n),
                     symmetric=True)


# ---------------------------------------------------------------------------
# the ABCD model (reference lib/Hodge_ST_Model.py:26-168)
# ---------------------------------------------------------------------------


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


def _inf(a):
    return np.where(a < 0, np.inf, a.astype(np.float64))


def _abcd_samples(fx, num_pool):
    """Per-graph samples with ``num_pool`` MLGC levels; level 0's assignment
    must equal the fixture's column 0 of x_t / x_s (deleted edges inf), and
    with two pools level 1's the columns of the ``in_c`` arrays."""
    n1 = np.concatenate([[0], np.cumsum(fx["num_node1_c"].astype(int))])
    e1 = np.concatenate([[0], np.cumsum(fx["num_edge1_c"].astype(int))])
    samples = []
    for i, g in enumerate(_split_graphs(fx)):
        s = build_complex(g["edge_index"], g["n"], x_t=g["x_t"][:, 1:], x_s=g["x_s"][:, 1:],
                          y=np.zeros(1))
        levels, pools = build_pyramid(list(s.levels), num_pool)
        np.testing.assert_array_equal(pools[0][0], g["x_t"][:, 0].astype(np.int64))
        np.testing.assert_array_equal(_inf(pools[0][1]), g["x_s"][:, 0].astype(np.float64))
        if num_pool == 2:
            np.testing.assert_array_equal(
                pools[1][0], fx["in_c/x_t"][n1[i]:n1[i + 1], 0].astype(np.int64))
            np.testing.assert_array_equal(
                _inf(pools[1][1]), fx["in_c/x_s"][e1[i]:e1[i + 1], 0].astype(np.float64))
        samples.append(dataclasses.replace(s, levels=levels, pools=pools))
    return samples


_ABCD = {
    # fixture: (pools, filters), the JAX tests' configurations
    "model_abcd_attpool": (1, (8, 16)),
    "model_abcd_attpool2": (2, (8, 16, 16)),
}


@pytest.mark.parametrize("name", list(_ABCD))
def test_abcd_model_matches_reference(name):
    """Flat layout, as the fixture was made; where the graphs share one
    structure (they do: the ABCD fixtures batch one skeleton twice) the
    shared dense layout too."""
    num_pool, filters = _ABCD[name]
    fx = _load(name)
    samples = _abcd_samples(fx, num_pool)
    cfg = BackboneConfig(
        channels=(2,) * len(filters), filters=filters, k=2, init_k=2, act="leaky_relu",
        deg_eps=1e-6, pool_locs=tuple(range(num_pool)), att_sigma="sigmoid", att_lam=0.9,
        att_dk=32, gate_input="last", gate_target="stack")
    entries, _ = _translate_hgcnn(_prefixed(fx, "sd/"), head="abcd")
    model = HLHGCNNAbcd(cfg, samples[0].x_s.shape[1], mlp_channels=(8,), num_classes=1,
                        nodes_per_graph=int(fx["coarse_nodes_per_graph"]),
                        edges_per_graph=int(fx["coarse_edges_per_graph"]))
    model.load_state_dict(from_flax_variables(_variables(entries)))
    model.eval()
    batches = [collate(samples, multiple=1).to("cpu")]
    shared = all(np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
                 for s in samples[1:] for a, b in zip(samples[0].levels, s.levels))
    assert shared
    batches.append(collate_dense_shared(samples).to("cpu"))
    for batch in batches:
        with torch.no_grad():
            out = model(batch)
        np.testing.assert_allclose(out.numpy(), fx["out"], **MODEL)


# ---------------------------------------------------------------------------
# layers: HL_filter (reference lib/Hodge_Cheb_Conv.py:117-188) and the
# Chebyshev conv (:366-440)
# ---------------------------------------------------------------------------


def _level(fx):
    n, e = fx["x_t"].shape[0], fx["x_s"].shape[0]
    ei = fx["edge_index"]
    return ComplexLevel(
        src=torch.from_numpy(ei[0].astype(np.int32)), dst=torch.from_numpy(ei[1].astype(np.int32)),
        node_mask=torch.ones(n), edge_mask=torch.ones(e),
        n_id=torch.zeros(n, dtype=torch.int32), s_id=torch.zeros(e, dtype=torch.int32),
        l0=_coo(fx["eit"], fx["ewt"], n), l1=_coo(fx["eis"], fx["ews"], e),
        deg=torch.from_numpy(fx["deg"].astype(np.float32)), num_graphs=1)


@pytest.mark.parametrize("name,if_dense", [("hlfilter_dense", True), ("hlfilter_plain", False)])
def test_hl_filter_matches_reference(name, if_dense):
    from test_reference_parity import _hlfilter_entries

    fx = _load(name)
    entries, _ = _hlfilter_entries(_prefixed(fx, "sd/"))
    mod = HLFilter(fx["x_t"].shape[1], fx["x_s"].shape[1], channels=2, filters=8, k=3,
                   if_dense=if_dense)
    mod.load_state_dict(from_flax_variables(_variables(entries)))
    mod.eval()
    with torch.no_grad():
        out_t, out_s = mod(torch.from_numpy(fx["x_t"]), torch.from_numpy(fx["x_s"]), _level(fx),
                           torch.from_numpy(fx["deg"]))
    np.testing.assert_allclose(out_t.numpy(), fx["out_t"], **LAYER)
    np.testing.assert_allclose(out_s.numpy(), fx["out_s"], **LAYER)


def test_cheb_conv_matches_reference():
    fx = _load("cheb_k4")
    sd = _prefixed(fx, "sd/")
    mod = ChebConv(fx["x"].shape[1], 6, 4)
    mod.load_state_dict({"weight": torch.from_numpy(np.stack(
        [sd[f"lins.{k}.weight"].T for k in range(4)])), "bias": torch.from_numpy(sd["bias"])})
    with torch.no_grad():
        out = mod(torch.from_numpy(fx["x"]), _coo(fx["eit"], fx["ewt"], fx["x"].shape[0]))
    np.testing.assert_allclose(out.numpy(), fx["out"], **LAYER)


# ---------------------------------------------------------------------------
# the real group data: fc2mask and the Shen-268 pyramid, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,mode", [("real", 1), ("real", 3), ("stack", 1), ("stack", 2),
                                        ("stack", 3)])
def test_fc2mask_matches_reference(which, mode):
    """Mode 3 carries the reference's loop-variable quirk."""
    fx = _load("fc2mask_real")
    if which == "real":
        ours = fc2mask(fx["fc_mean"][None].astype(np.float32), percent=0.25, mode=mode)
    else:
        ours = fc2mask(fx["stack"], percent=0.2, mode=mode)
    np.testing.assert_array_equal(ours, fx[f"{which}_mode{mode}"].astype(np.float32))


def test_shen268_pyramid_matches_reference():
    """The skeleton of ``model_hgat_attpool`` through the port's brain MLGC
    (torch generator seeded with 10086): both levels' assignments, the
    coarse edge lists, the simplex counts and level 1's nodes plus edges,
    2815, the flatten-head width of the shipped checkpoint."""
    fx = _load("model_hgat_attpool")
    levels, pools = brain_pyramid(fx["skeleton_src"], fx["skeleton_dst"], fx["skeleton_val"],
                                  pool_num=2, seed=10086)
    np.testing.assert_array_equal(levels[0].src, fx["skeleton_src"])
    np.testing.assert_array_equal(levels[0].dst, fx["skeleton_dst"])
    for k, (pt, ps) in enumerate([("pos_t0", "pos_s0"), ("pos_t1", "pos_s1")]):
        np.testing.assert_array_equal(_inf(pools[k][0]), fx[pt].reshape(-1).astype(np.float64))
        np.testing.assert_array_equal(_inf(pools[k][1]), fx[ps].reshape(-1).astype(np.float64))
    for lvl, key in [(levels[1], "l1_edge_index"), (levels[2], "l2_edge_index")]:
        np.testing.assert_array_equal(np.stack([lvl.src, lvl.dst]), fx[key])
    assert [lv.num_nodes for lv in levels] == fx["num_node"].tolist()
    assert [lv.num_edges for lv in levels] == fx["num_edge"].tolist()
    assert levels[1].num_nodes + levels[1].num_edges == 2815 == fx["latent"].shape[1]


def test_real_skeleton_reproduces_the_fixture_skeleton():
    """``real_skeleton`` on the real group FC of ``fc2mask_real`` masked by
    the fixture skeleton's pattern gives that skeleton, in row-major order,
    with its FC weights (negative FC clamped to 0.001)."""
    fx = _load("model_hgat_attpool")
    fc = _load("fc2mask_real")["fc_mean"]
    mask = np.zeros_like(fc)
    mask[fx["skeleton_src"], fx["skeleton_dst"]] = 1.0
    src, dst, w = real_skeleton(fc, mask)
    np.testing.assert_array_equal(src, fx["skeleton_src"])
    np.testing.assert_array_equal(dst, fx["skeleton_dst"])
    np.testing.assert_allclose(w, fx["skeleton_val"], rtol=1e-6)
