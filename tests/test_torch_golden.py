"""The port's layers against fixtures produced by the reference code
(``tests/golden/reference/*.npz``, as ``tests/test_reference_parity.py``
holds the JAX modules): ``LaguerreConv`` on a COO Laplacian, 2-D and 3-D
input, and the value-mode ``NodeEdgeInt`` in eval and train mode.  The
fixtures are stored in COO form (``eit``/``ewt``, ``edge_index``), so they
run on the flat layout.  Tolerance rtol 1e-4, atol 1e-5, the JAX tests'.
"""

import os

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.batch import ComplexLevel, CooMatrix
from hl_hgat_tpu_torch.complex.build import coo_to_ell
from hl_hgat_tpu_torch.nn.conv import LaguerreConv
from hl_hgat_tpu_torch.nn.interaction import NodeEdgeInt

FIX_DIR = os.path.join(os.path.dirname(__file__), "golden", "reference")
TOL = dict(rtol=1e-4, atol=1e-5)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIX_DIR), reason="reference fixtures not generated")


def _load(name):
    with np.load(os.path.join(FIX_DIR, f"{name}.npz")) as z:
        fx = {k: z[k] for k in z.files}
    return fx, {k[3:]: v for k, v in fx.items() if k.startswith("sd/")}


def _coo(eit, ewt, n, with_ell):
    rows, cols, vals = eit[0].astype(np.int32), eit[1].astype(np.int32), ewt.astype(np.float32)
    ell = coo_to_ell(rows, cols, vals, n) if with_ell else (None, None)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return CooMatrix(rows=t(rows), cols=t(cols), vals=t(vals), shape=(n, n),
                     ell_cols=t(ell[0]), ell_vals=t(ell[1]), symmetric=True)


def _conv_from(sd):
    ks = sorted(int(k.split(".")[1]) for k in sd if k.startswith("lins."))
    weights = np.stack([sd[f"lins.{k}.weight"].T for k in ks])  # [F, C] → [C, F] per term
    conv = LaguerreConv(weights.shape[1], weights.shape[2], len(ks))
    conv.load_state_dict({"weight": torch.from_numpy(weights), "bias": torch.from_numpy(sd["bias"])})
    return conv


@pytest.mark.parametrize("with_ell", [False, True], ids=["coo", "ell"])
@pytest.mark.parametrize("name", ["laguerre_k1", "laguerre_k2", "laguerre_k3", "laguerre_k5",
                                  "laguerre_3d_k3"])
def test_laguerre_conv_matches_reference(name, with_ell):
    fx, sd = _load(name)
    lap = _coo(fx["eit"], fx["ewt"], fx["x"].shape[0], with_ell)
    with torch.no_grad():
        out = _conv_from(sd)(torch.from_numpy(fx["x"]), lap)
    assert out.shape == fx["out"].shape
    np.testing.assert_allclose(out.numpy(), fx["out"], **TOL)


def _level(edge_index, n, e, deg):
    dummy = lambda size: CooMatrix(  # noqa: E731
        rows=torch.zeros(1, dtype=torch.int32), cols=torch.zeros(1, dtype=torch.int32),
        vals=torch.zeros(1), shape=(size, size), symmetric=True)
    return ComplexLevel(
        src=torch.from_numpy(edge_index[0].astype(np.int32)),
        dst=torch.from_numpy(edge_index[1].astype(np.int32)),
        node_mask=torch.ones(n), edge_mask=torch.ones(e),
        n_id=torch.zeros(n, dtype=torch.int32), s_id=torch.zeros(e, dtype=torch.int32),
        l0=dummy(n), l1=dummy(e), deg=torch.from_numpy(deg.astype(np.float32)), num_graphs=1)


def _msi_from(sd, c_t, c_s):
    msi = NodeEdgeInt(c_t, c_s, 8)
    names = {"0": "TorchLinear_0", "1": "MaskedBatchNorm_0", "3": "TorchLinear_1",
             "4": "MaskedBatchNorm_1"}
    state = {}
    for key, val in sd.items():
        head, idx, leaf = key.split(".")
        if leaf != "num_batches_tracked":
            state[f"{head}.{names[idx]}.{leaf}"] = torch.from_numpy(val)
    msi.load_state_dict(state)
    return msi


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_msi_value_matches_reference(mode):
    """Train mode: BN on batch statistics, as the reference's BatchNorm1d
    inside the WV Sequentials."""
    fx, sd = _load(f"msi_value_{mode}")
    x_t, x_s = torch.from_numpy(fx["x_t"]), torch.from_numpy(fx["x_s"])
    level = _level(fx["edge_index"], x_t.shape[0], x_s.shape[0], fx["deg"])
    msi = _msi_from(sd, x_t.shape[1], x_s.shape[1])
    msi.train(mode == "train")
    with torch.no_grad():
        out_t, out_s = msi(x_t, x_s, level, torch.from_numpy(fx["deg"]))
    np.testing.assert_allclose(out_t.numpy(), fx["out_t"], **TOL)
    np.testing.assert_allclose(out_s.numpy(), fx["out_s"], **TOL)


# ---------------------------------------------------------------------------
# the full zinc_pyr model (reference lib/Hodge_ST_Model.py:544-646)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat_ell", "flat_coo", "packed"])
def test_model_zinc_pyr_matches_reference(layout):
    """The reference model's own output, from its own state dict, on every
    layout the package has; the collated L0 must equal the reference's."""
    from hl_hgat_tpu_torch.utils.torch_import import _translate_hgcnn
    from hl_hgat_tpu_torch.complex.build import build_complex, collate
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph
    from hl_hgat_tpu_torch.weights import from_flax_variables

    fx, sd = _load("model_zinc_pyr")
    n_off = np.concatenate([[0], np.cumsum(fx["num_node1"].astype(int))])
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    ei = fx["in/edge_index"]
    samples = []
    for g in range(len(n_off) - 1):
        cols = (ei[0] >= n_off[g]) & (ei[0] < n_off[g + 1])
        samples.append(build_complex(
            ei[:, cols] - n_off[g], int(n_off[g + 1] - n_off[g]),
            x_t=fx["in/x_t"][n_off[g]:n_off[g + 1]],
            x_s=fx["in/x_s"][e_off[g]:e_off[g + 1]], y=np.zeros(1)))
    if layout == "packed":
        batch = collate_dense_packed(samples)
    else:
        batch = collate(samples, multiple=1, with_ell=layout == "flat_ell")
        l0 = batch.level0.l0
        ours = np.zeros(l0.shape)
        ours[l0.rows, l0.cols] = l0.vals
        ref = np.zeros(l0.shape)
        ref[fx["in/edge_index_t"][0], fx["in/edge_index_t"][1]] = fx["in/edge_weight_t"]
        np.testing.assert_allclose(ours, ref, **TOL)

    variables = {"params": {}, "batch_stats": {}}
    for (col, path), val in _translate_hgcnn(sd, head="graph")[0].items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), k=3, init_k=3, deg_eps=0.0)
    model = HLHGCNNGraph(cfg, fx["in/x_t"].shape[1], fx["in/x_s"].shape[1],
                         mlp_channels=(), num_classes=1)
    model.load_state_dict(from_flax_variables(variables))
    with torch.no_grad():
        out = model.eval()(batch.to("cpu"))
    np.testing.assert_allclose(out.numpy(), fx["out"], rtol=1e-4, atol=1e-4)
