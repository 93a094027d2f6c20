"""The port's reference state-dict importers
(``hl_hgat_tpu_torch/utils/torch_import.py``) against the JAX package's
(``hl_hgat_tpu/utils/torch_import.py``) on the CPU: the translation tables
entry for entry on every state dict of the reference fixtures, the
fixtures' outputs through ``import_hgcnn``, ``import_hgat_attpool`` on a
reference-format state dict, and the strict checks."""

import glob
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_brain_fixtures as brain_fx  # noqa: E402
import test_torch_pool_fixtures as pool_fx  # noqa: E402
import test_torch_tsp as tsp_fx  # noqa: E402

from hl_hgat_tpu.utils import torch_import as J  # noqa: E402
from hl_hgat_tpu_torch.complex.build import build_complex  # noqa: E402
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed  # noqa: E402
from hl_hgat_tpu_torch.models import presets  # noqa: E402
from hl_hgat_tpu_torch.models.abcd import HLHGCNNAbcd  # noqa: E402
from hl_hgat_tpu_torch.models.backbone import (  # noqa: E402
    BackboneConfig,
    HLHGCNNGraph,
    HLHGCNNTsp,
)
from hl_hgat_tpu_torch.utils import torch_import as P  # noqa: E402

FIX = os.path.join(os.path.dirname(__file__), "golden", "reference")
MODEL = dict(rtol=1e-4, atol=1e-4)


def _state_dicts():
    """(fixture, prefix, head) of every reference state dict in the fixtures."""
    out = []
    for path in sorted(glob.glob(os.path.join(FIX, "*.npz"))):
        name = os.path.basename(path)[:-4]
        with np.load(path) as z:
            prefixes = sorted({k.split("/")[0] for k in z.files
                               if "/" in k and "HL_init_conv" in k})
        head = "tsp" if "tsp" in name else "abcd" if "abcd" in name else "graph"
        out += [(name, p, head) for p in prefixes]
    return out


STATE_DICTS = _state_dicts()


def _sd(name, prefix):
    with np.load(os.path.join(FIX, name + ".npz")) as z:
        return {k[len(prefix) + 1:]: z[k] for k in z.files if k.startswith(prefix + "/")}


def _assert_same_entries(ours, ref):
    (e1, r1), (e2, r2) = ours, ref
    assert list(e1) == list(e2)
    for key in e2:
        assert e1[key].dtype == e2[key].dtype, key
        np.testing.assert_array_equal(e1[key], e2[key], err_msg=str(key))
    for field in ("consumed", "dropped", "unmatched"):
        assert getattr(r1, field) == getattr(r2, field), field


def test_every_fixture_state_dict_is_found():
    assert len(STATE_DICTS) >= 24
    assert {h for _, _, h in STATE_DICTS} == {"graph", "tsp", "abcd"}


@pytest.mark.parametrize("name,prefix,head", STATE_DICTS)
def test_translate_hgcnn_tables_agree(name, prefix, head):
    sd = _sd(name, prefix)
    _assert_same_entries(P._translate_hgcnn(sd, head=head), J._translate_hgcnn(sd, head=head))
    if prefix == "sd":
        assert P.infer_hgcnn_config(sd) == J.infer_hgcnn_config(sd)


# ---------------------------------------------------------------------------
# import_hgcnn: the fixtures' outputs
# ---------------------------------------------------------------------------


def _zinc_pyr_case():
    fx = dict(np.load(os.path.join(FIX, "model_zinc_pyr.npz")))
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
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), k=3, init_k=3, deg_eps=0.0)
    model = HLHGCNNGraph(cfg, fx["in/x_t"].shape[1], fx["in/x_s"].shape[1],
                         mlp_channels=(), num_classes=1)
    return fx, model, "graph", collate_dense_packed(samples).to("cpu"), None


def _pooled_case(name):
    pooled, kw, mlp, classes = pool_fx.MODELS[name]
    fx = pool_fx._load(name)
    samples = pool_fx._samples(fx, pooled)
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), **kw)
    model = HLHGCNNGraph(cfg, samples[0].x_t.shape[1], samples[0].x_s.shape[1],
                         mlp_channels=mlp, num_classes=classes)
    return fx, model, "graph", pool_fx._batch(samples, "dense"), None


def _tsp_case():
    fx = tsp_fx._fixture("model_tsp_pyr")
    batch = tsp_fx._fixture_batch(tsp_fx._fixture_samples(fx), "packed")
    model = HLHGCNNTsp(BackboneConfig(channels=(2, 2), filters=(8, 16), k=2, init_k=2),
                       2, 2, mlp_channels=(8,))
    return fx, model, "tsp", batch, tsp_fx._per_edge


def _abcd_case(name):
    num_pool, filters = brain_fx._ABCD[name]
    fx = brain_fx._load(name)
    samples = brain_fx._abcd_samples(fx, num_pool)
    cfg = BackboneConfig(
        channels=(2,) * len(filters), filters=filters, k=2, init_k=2, act="leaky_relu",
        deg_eps=1e-6, pool_locs=tuple(range(num_pool)), att_sigma="sigmoid", att_lam=0.9,
        att_dk=32, gate_input="last", gate_target="stack")
    model = HLHGCNNAbcd(cfg, samples[0].x_s.shape[1], mlp_channels=(8,), num_classes=1,
                        nodes_per_graph=int(fx["coarse_nodes_per_graph"]),
                        edges_per_graph=int(fx["coarse_edges_per_graph"]))
    from hl_hgat_tpu_torch.complex.dense import collate_dense_shared

    return fx, model, "abcd", collate_dense_shared(samples).to("cpu"), None


CASES = {
    "model_zinc_pyr": _zinc_pyr_case,
    **{name: (lambda n=name: _pooled_case(n)) for name in pool_fx.MODELS},
    "model_tsp_pyr": _tsp_case,
    **{name: (lambda n=name: _abcd_case(n)) for name in brain_fx._ABCD},
}


def test_every_model_fixture_has_a_case():
    models = {n for n, p, _ in STATE_DICTS if n.startswith("model_") and p == "sd"}
    assert set(CASES) == models


@pytest.mark.parametrize("name", list(CASES))
def test_import_hgcnn_reproduces_the_fixture(name):
    fx, model, head, batch, per_edge = CASES[name]()
    sd = {k[3:]: fx[k] for k in fx if k.startswith("sd/")}
    out_model, report = P.import_hgcnn(model, sd, head=head)
    assert out_model is model and not report.unmatched and not report.untouched
    assert report.dropped == [k for k in sd if k.endswith("num_batches_tracked")]
    with torch.no_grad():
        out = model.eval()(batch)
    out = out.numpy() if per_edge is None else per_edge(out.numpy(), batch)
    np.testing.assert_allclose(out, fx["out"], **MODEL)


# ---------------------------------------------------------------------------
# import_hgat_attpool: a reference-format state dict made from a port model
# ---------------------------------------------------------------------------


_NEINT_INDEX = {"TorchLinear_0": "0", "MaskedBatchNorm_0": "1", "TorchLinear_1": "3",
                "MaskedBatchNorm_1": "4"}


def _reference_state_dict(model) -> dict[str, np.ndarray]:
    """The state dict the reference's ``HL_HGAT_attpool`` would hold for
    the port model's weights (the importer's tables, inverted)."""
    sd = {}

    def lag(base, leaf, a):
        if leaf == "bias":
            sd[f"{base}.bias"] = a
        else:
            for k in range(a.shape[0]):
                sd[f"{base}.lins.{k}.weight"] = np.ascontiguousarray(a[k].T)

    def bn(base, leaf, a):
        sd[f"{base}.{leaf}"] = a
        if leaf == "running_var":
            sd[f"{base}.num_batches_tracked"] = np.asarray(7)

    for name, t in model.state_dict().items():
        a, parts = t.numpy().copy(), name.split(".")
        if parts[0] == "node_embedding":
            if parts[1].startswith("bn"):
                bn(".".join(parts[:2]), parts[2], a)
            else:
                sd[name] = a
        elif parts[0] == "backbone" and parts[1].startswith(("init_", "NEConv")):
            if parts[1].startswith("init_"):
                head, side, sub, leaf = "HL_init_conv", parts[1][5:], parts[2], parts[3]
            else:
                head, side, sub, leaf = parts[1], parts[2], parts[3], parts[4]
            conv_mod, bn_mod = ("module_0", "module_1") if side == "node" else (
                "module_4", "module_5")
            if sub == "conv":
                lag(f"{head}.{conv_mod}", leaf, a)
            else:
                bn(f"{head}.{bn_mod}.module", leaf, a)
        elif parts[0] == "backbone" and parts[1].startswith("NEInt"):
            base = f"{parts[1]}.{parts[2]}.{_NEINT_INDEX[parts[3]]}"
            if "BatchNorm" in parts[3]:
                bn(base, parts[4], a)
            else:
                sd[f"{base}.{parts[4]}"] = a
        elif parts[0] == "backbone" and parts[1].startswith("NEAtt"):
            sd[".".join(parts[1:])] = a
        elif parts[0] in ("readout_node", "readout_edge"):
            lag("readout.module_0" if parts[0] == "readout_node" else "readout.module_1",
                parts[1], a)
        elif parts[0] == "head" and parts[1] == "out":
            sd[f"out.{parts[2]}"] = a
        elif parts[0] == "head":
            i, kind = parts[1][3:].split("_")
            if kind == "lin":
                sd[f"mlp{i}.0.{parts[2]}"] = a
            else:
                bn(f"mlp{i}.1", parts[2], a)
        else:
            raise KeyError(name)
    return sd


def _hgat(seed):
    model, _ = presets.hgat_attpool(
        channels=(2, 2), filters=(8, 16), k=3, pool_num=1, mlp_channels=(8,),
        nodes_per_graph=5, edges_per_graph=7, fine_nodes_per_graph=10,
        fine_edges_per_graph=12, device="cpu", seed=seed)
    with torch.no_grad():  # non-trivial running statistics
        g = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model


def test_import_hgat_attpool_round_trip():
    src = _hgat(1)
    sd = _reference_state_dict(src)
    _assert_same_entries(P._translate_hgat(sd), J._translate_hgat(sd))
    dst = _hgat(2)
    _, report = P.import_hgat_attpool(dst, sd)
    assert not report.unmatched and not report.untouched
    assert len(report.dropped) == sum(k.endswith("num_batches_tracked") for k in sd)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    cfg = P.infer_hgat_config(sd)
    assert cfg == J.infer_hgat_config(sd)
    assert cfg["channels"] == (2, 2) and cfg["filters"] == (8, 16) and cfg["k"] == 3


# ---------------------------------------------------------------------------
# the strict checks
# ---------------------------------------------------------------------------


def _zinc_sd():
    return _sd("model_zinc_pyr", "sd")


def _zinc_model():
    return _zinc_pyr_case()[1]


@pytest.mark.parametrize("damage,message", [
    ("extra", "unmatched checkpoint key"),
    ("shape", "shape mismatch"),
    ("missing", "not covered by the checkpoint"),
    ("nowhere", "no model leaf"),
])
def test_strict_import_refuses_and_writes_nothing(damage, message):
    sd = _zinc_sd()
    if damage == "extra":
        sd["mystery.weight"] = np.zeros(3, np.float32)
    elif damage == "shape":
        sd["out.bias"] = np.zeros(2, np.float32)
    elif damage == "missing":
        del sd["out.bias"]
    else:
        sd["NEConv99.module_0.bias"] = np.zeros(8, np.float32)
    model = _zinc_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=message):
        P.import_hgcnn(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(before[k], v), k
    # not strict: the same problems are reported, the rest is loaded
    _, report = P.import_hgcnn(model, sd, strict=False)
    if damage in ("extra", "shape", "nowhere"):
        assert report.unmatched
    else:
        assert report.untouched == ["head.out.bias"]


def test_load_torch_state_dict(tmp_path):
    model = _zinc_model()
    torch.save(model.state_dict(), tmp_path / "sd.pt")
    loaded = P.load_torch_state_dict(str(tmp_path / "sd.pt"))
    ref = J.load_torch_state_dict(str(tmp_path / "sd.pt"))
    assert list(loaded) == list(ref) == list(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(loaded[k], v.numpy())
        np.testing.assert_array_equal(ref[k], v.numpy())
