"""The port's analysis layer and the last JAX functions it lacked, against
the JAX package on the CPU: the native MLGC matcher (``graclus_match``,
``coarse_edges``) and ``mlgc`` in its weighted, unweighted and brain
cases, ``par2adj`` / ``post2poss`` / ``unbatch_edge_attr``, the unpacked
dense layout (``collate_dense``, and a pooled model's forward on it), the
two synthetic batches, ``REFERENCE_BRAIN_DIR``, ``cross_simplex``, the
backbone's per-layer snapshots and ``make_backbone``, ``utils.viz`` and
``utils.profiling``.

Inputs are seeded with numpy; parameters cross from flax with
``weights.from_flax_variables`` or go the other way with
``weights.to_flax_paths``.  Host-side arrays must be equal; float32
tolerances are stated at each test with their reason.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu import native as jnative
from hl_hgat_tpu.complex import build as jbuild
from hl_hgat_tpu.complex import coarsen as jcoarsen
from hl_hgat_tpu.complex import dense as jdense
from hl_hgat_tpu.data import synthetic as jsynthetic
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.models.backbone import BackboneConfig as JBackboneConfig
from hl_hgat_tpu.models.backbone import make_backbone as jmake_backbone
from hl_hgat_tpu.nn import interaction as jinteraction
from hl_hgat_tpu.utils import viz as jviz
from hl_hgat_tpu_torch import native
from hl_hgat_tpu_torch.complex import build, coarsen, dense
from hl_hgat_tpu_torch.data import brain, synthetic
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, make_backbone
from hl_hgat_tpu_torch.nn import interaction
from hl_hgat_tpu_torch.ops import nan_checks
from hl_hgat_tpu_torch.utils import profiling, viz
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

# whole-model forwards and the snapshots (the JAX tests' model tolerance)
MODEL_ATOL = 1e-4
# one product pair in another summation order
F32_ATOL = 1e-5


def _arrays(obj, prefix=""):
    """Every array leaf of a (nested) batch dataclass, by path."""
    if obj is None or isinstance(obj, (int, float, str)):
        return {}
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_arrays(v, f"{prefix}{i}."))
        return out
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_arrays(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix.rstrip("."): np.asarray(obj)}


def _assert_same_arrays(ours, ref):
    a, b = _arrays(ours), _arrays(ref)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _flax_variables(module):
    """The port module's tensors as flax variables (skips the JAX init)."""
    out = {"params": {}, "batch_stats": {}}
    for path, arr in to_flax_paths(module, module.state_dict()).items():
        node = out["batch_stats" if path[-1] in ("mean", "var") else "params"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr)
    return out


def _skeleton(seed, n=40, extra=90):
    rng = np.random.default_rng(seed)
    pairs = {(i, i + 1) for i in range(n - 1)}
    for a, b in rng.integers(0, n, (extra, 2)):
        if a != b:
            pairs.add((int(min(a, b)), int(max(a, b))))
    arr = np.array(sorted(pairs), np.int32)
    # continuous weights with a few exact ties
    w = np.round(rng.uniform(0.05, 1.0, arr.shape[0]), 2)
    return arr[:, 0], arr[:, 1], w, n


# ---------------------------------------------------------------------------
# the native MLGC matcher and mlgc: bit-equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_native_matcher_equals_the_jax_binding(weighted):
    src, dst, w, n = _skeleton(1)
    weight = w if weighted else None
    rep = native.graclus_match(src, dst, weight, n)
    ref = jnative.graclus_match(src, dst, weight, n)
    assert rep.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(rep, ref)
    csrc, cdst, c_edge = native.coarse_edges(np.unique(rep, return_inverse=True)[1], src, dst)
    jsrc, jdst, jc_edge = jnative.coarse_edges(np.unique(ref, return_inverse=True)[1], src, dst)
    for a, b in ((csrc, jsrc), (cdst, jdst), (c_edge, jc_edge)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (c_edge == -1).any() and native.available()


_MLGC_CASES = {
    "unweighted": dict(),
    "weighted": dict(edge_weight=True),
    "brain": dict(edge_weight=True, x_s=True, prune_single_fine_edges=True,
                  drop_isolated_nodes=True),
}


@pytest.mark.parametrize("case", list(_MLGC_CASES))
def test_mlgc_takes_the_native_path_and_equals_jax(case, monkeypatch):
    """Two steps, the second on the first's unsorted coarse edge list: the
    assignments and coarse edges bit-equal, and the step never reaches the
    Python walk."""
    src, dst, w, n = _skeleton(2)
    kw = dict(_MLGC_CASES[case])
    walks = []
    monkeypatch.setattr(coarsen, "graclus_cluster", lambda *a, **k: walks.append(a))
    ours = [build.build_structure(src, dst, n)]
    ref = [jbuild.build_structure(src, dst, n)]
    weight = w
    for _ in range(2):
        step_kw = dict(kw)
        if kw.get("edge_weight"):
            step_kw["edge_weight"] = weight
        if kw.get("x_s"):
            step_kw["x_s"] = weight.reshape(-1, 1)
        a = coarsen.mlgc(ours[-1], **step_kw)
        b = jcoarsen.mlgc(ref[-1], **step_kw)
        for name in ("c_node", "c_edge", "x_s_pool"):
            if getattr(b, name) is None:
                assert getattr(a, name) is None
                continue
            assert getattr(a, name).dtype == getattr(b, name).dtype, name
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        for name in ("src", "dst", "l0_rows", "l0_cols", "l0_vals", "l1_vals"):
            np.testing.assert_array_equal(getattr(a.structure, name), getattr(b.structure, name))
        ours.append(a.structure)
        ref.append(b.structure)
        weight = (a.x_s_pool.reshape(-1) if kw.get("x_s")
                  else np.abs(np.random.default_rng(3).standard_normal(a.structure.num_edges)))
    assert walks == []
    # the second step matched an edge list that is not row-major
    order = np.lexsort((ours[1].dst, ours[1].src))
    assert not np.array_equal(order, np.arange(order.size))


def test_build_pyramid_of_pooled_samples_equals_jax():
    """Three unweighted levels (the pooled datasets' pyramids)."""
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    ours = synthetic.random_simplex_sample(rng_a, n_nodes=60, extra_edges=40, num_pool=3)
    ref = jsynthetic.random_simplex_sample(rng_b, n_nodes=60, extra_edges=40, num_pool=3)
    for (a_n, a_e), (b_n, b_e) in zip(ours.pools, ref.pools):
        np.testing.assert_array_equal(a_n, b_n)
        np.testing.assert_array_equal(a_e, b_e)
    assert [s.num_edges for s in ours.levels] == [s.num_edges for s in ref.levels]


# ---------------------------------------------------------------------------
# build.py helpers, the unpacked dense layout, synthetic batches
# ---------------------------------------------------------------------------


def test_par2adj_post2poss_unbatch_edge_attr_equal_jax():
    src, dst, _, n = _skeleton(5, n=25, extra=40)
    b1 = build.boundary_dense(src, dst, n)
    edge_index = build.par2adj(b1)
    ref = jbuild.par2adj(b1)
    assert edge_index.dtype == ref.dtype
    np.testing.assert_array_equal(edge_index, ref)
    np.testing.assert_array_equal(edge_index, np.stack([src, dst]))

    step = coarsen.mlgc(build.build_structure(src, dst, n))
    coarse = np.stack([step.structure.src, step.structure.dst])
    pos_s = build.post2poss(step.c_node, edge_index, coarse)
    np.testing.assert_array_equal(pos_s, jbuild.post2poss(step.c_node, edge_index, coarse))
    np.testing.assert_array_equal(pos_s, step.c_edge)

    batch = build.collate([synthetic.random_simplex_sample(np.random.default_rng(i))
                           for i in range(3)])
    lvl = batch.level0
    ours = build.unbatch_edge_attr(batch.x_s, lvl.s_id, lvl.edge_mask, 3)
    theirs = jbuild.unbatch_edge_attr(batch.x_s, lvl.s_id, lvl.edge_mask, 3)
    assert len(ours) == 3 and sum(len(o) for o in ours) == int(lvl.edge_mask.sum())
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _sample_pairs(seed, count, num_pool):
    ours = [synthetic.random_simplex_sample(np.random.default_rng(seed + i), num_pool=num_pool,
                                            n_nodes=20 + 3 * i)
            for i in range(count)]
    ref = [jsynthetic.random_simplex_sample(np.random.default_rng(seed + i), num_pool=num_pool,
                                            n_nodes=20 + 3 * i)
           for i in range(count)]
    return ours, ref


@pytest.mark.parametrize("num_pool,multiple,y_per_edge", [(0, 8, False), (1, 8, False),
                                                          (2, 1, False), (0, 4, True)])
def test_collate_dense_matches_jax_array_by_array(num_pool, multiple, y_per_edge):
    ours, ref = _sample_pairs(10, 4, num_pool)
    if y_per_edge:
        for s in ours + ref:
            s.y = np.arange(s.num_edges, dtype=np.float32)
    pads = dense.dense_pad_spec(ours, multiple=multiple)
    assert pads == [dense.DensePad(p.nodes, p.edges)
                    for p in jdense.dense_pad_spec(ref, multiple=multiple)]
    a = dense.collate_dense(ours, multiple=multiple, y_per_edge=y_per_edge)
    b = jdense.collate_dense(ref, multiple=multiple, y_per_edge=y_per_edge)
    assert a.num_graphs == b.num_graphs == 4 and a.level0.n_gid is None
    _assert_same_arrays(a, b)


def test_collate_dense_raises_when_a_sample_exceeds_the_pad():
    ours, _ = _sample_pairs(10, 2, 0)
    small = [dense.DensePad(nodes=8, edges=8)]
    with pytest.raises(ValueError, match="exceeds dense pad"):
        dense.collate_dense(ours, small)


def test_pooled_model_reads_the_unpacked_layout_as_jax():
    """``cifar10sp_attpool`` (pooling, max-normalized gates, graph readout)
    on a ``collate_dense`` batch: the dispatch's masked block mean, the
    per-graph pools and gates, against the JAX model on the same batch."""
    ours, ref = _sample_pairs(20, 4, 1)
    batch = dense.collate_dense(ours).to("cpu")
    jbatch = jax.tree.map(jnp.asarray, jdense.collate_dense(ref))
    kw = dict(channels=(1, 1), filters=(8, 16), k=2, mlp_channels=(8,), dropout=0.0)
    model, _ = presets.cifar10sp_attpool(**kw, in_t=batch.x_t.shape[-1], in_s=batch.x_s.shape[-1],
                                         seed=3, device="cpu")
    jmodel, _ = jpresets.cifar10sp_attpool(**kw)
    with torch.inference_mode():
        out = model.eval()(batch)
    ref_out = np.asarray(jmodel.apply(_flax_variables(model), jbatch, deterministic=True))
    assert out.shape == ref_out.shape == (4, 10) and float(np.std(ref_out)) > 1e-4
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=0, atol=MODEL_ATOL)


def test_synthetic_tsp_and_brain_batches_equal_jax():
    _assert_same_arrays(synthetic.synthetic_tsp_batch(3, seed=2),
                        jsynthetic.synthetic_tsp_batch(3, seed=2))
    a, n_a, e_a = synthetic.synthetic_brain_batch(3, seed=1, n_rois=20, t_len=16)
    b, n_b, e_b = jsynthetic.synthetic_brain_batch(3, seed=1, n_rois=20, t_len=16)
    assert (n_a, e_a) == (n_b, e_b)
    _assert_same_arrays(a, b)


def test_reference_brain_dir_comes_from_the_environment(monkeypatch, tmp_path):
    """The group data directory is $HLHGAT_BRAIN_DIR's, never a path
    derived from where the package lies; the loaders default to it and
    raise when it is unset."""
    import importlib
    import inspect

    monkeypatch.delenv(brain.BRAIN_DIR_ENV, raising=False)
    try:
        unset = importlib.reload(brain)
        assert unset.REFERENCE_BRAIN_DIR is None and not unset.reference_data_available()
        for fn in (unset.load_group_fc, unset.load_affiliations,
                   unset.build_real_brain_pyramid):
            assert inspect.signature(fn).parameters["data_dir"].default is None
        with pytest.raises(FileNotFoundError, match=brain.BRAIN_DIR_ENV):
            unset.load_group_fc()
        monkeypatch.setenv(brain.BRAIN_DIR_ENV, str(tmp_path))
        assert importlib.reload(brain).REFERENCE_BRAIN_DIR == str(tmp_path)
        assert brain.reference_data_available()
    finally:
        monkeypatch.undo()
        importlib.reload(brain)


# ---------------------------------------------------------------------------
# cross_simplex, MSI, backbone snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["flat", "dense"])
def test_cross_simplex_matches_jax(layout):
    ours, ref = _sample_pairs(30, 3, 0)
    if layout == "flat":
        batch, jbatch = build.collate(ours).to("cpu"), jbuild.collate(ref)
    else:
        batch, jbatch = dense.collate_dense(ours).to("cpu"), jdense.collate_dense(ref)
    jbatch = jax.tree.map(jnp.asarray, jbatch)
    rng = np.random.default_rng(7)
    x_t = rng.standard_normal(tuple(batch.x_t.shape[:-1]) + (5,)).astype(np.float32)
    x_s = rng.standard_normal(tuple(batch.x_s.shape[:-1]) + (5,)).astype(np.float32)
    deg = np.asarray(batch.level0.deg) + 1e-6
    got = interaction.cross_simplex(torch.from_numpy(x_t), torch.from_numpy(x_s), batch.level0,
                                    torch.from_numpy(deg))
    want = jinteraction.cross_simplex(jnp.asarray(x_t), jnp.asarray(x_s), jbatch.level0,
                                      jnp.asarray(deg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=F32_ATOL)
    assert interaction.MSI is interaction.NodeEdgeInt


def _tsp_backbone_pair(seed=0):
    """The figures' TSP backbone: JAX ``make_backbone`` initialized on the
    JAX synthetic TSP batch, the port's carrying its variables."""
    jbatch = jax.tree.map(jnp.asarray, jsynthetic.synthetic_tsp_batch(4, seed=seed))
    jcfg = JBackboneConfig(channels=(2, 2), filters=(8, 16), k=2, init_k=2)
    jbb = jmake_backbone(jcfg)
    jx_s = jbatch.x_s[..., :-1]
    v = jax.jit(jbb.init, static_argnums=4)(jax.random.key(seed), jbatch.x_t, jx_s, jbatch, True)
    feats = jax.jit(jbb.apply, static_argnums=4)(v, jbatch.x_t, jx_s, jbatch, True)
    bb = make_backbone(BackboneConfig(channels=(2, 2), filters=(8, 16), k=2, init_k=2), 2, 1)
    bb.load_state_dict(from_flax_variables(v))
    return bb.eval(), feats, jbatch


def test_backbone_snapshots_and_feature_trends_match_jax():
    bb, feats, jbatch = _tsp_backbone_pair()
    batch = synthetic.synthetic_tsp_batch(4, seed=0).to("cpu")
    with torch.inference_mode():
        x_t, x_s, snaps = bb(batch.x_t, batch.x_s[..., :-1], batch, return_snapshots=True)
        plain = bb(batch.x_t, batch.x_s[..., :-1], batch)
    assert len(plain) == 2 and len(snaps) == len(feats["snapshots"]) == 4
    torch.testing.assert_close(plain[0], x_t, rtol=0, atol=0)
    for (t, s), (jt, js) in zip(snaps, feats["snapshots"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=MODEL_ATOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=MODEL_ATOL)
    ours = viz.feature_trends(snaps, batch.levels[0])
    ref = jviz.feature_trends([(np.asarray(t), np.asarray(s)) for t, s in feats["snapshots"]],
                              jbatch.levels[0])
    for key in ("node", "edge"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=MODEL_ATOL)


def test_snapshots_with_gates_and_pooling_follow_the_layers():
    """A gated, pooled backbone: one snapshot per conv layer, each on its
    own level's rows, returned after the gates; the default return and the
    atts return are unchanged."""
    cfg = BackboneConfig(channels=(1, 2), filters=(8, 8), k=2, pool_locs=(0,),
                         gate_input="stack", stack_concat="layer")
    ours, _ = _sample_pairs(40, 3, 1)
    batch = build.collate(ours).to("cpu")
    bb = make_backbone(cfg, batch.x_t.shape[-1], batch.x_s.shape[-1],
                       torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        x_t, x_s, atts, snaps = bb(batch.x_t, batch.x_s, batch, return_atts=True,
                                   return_snapshots=True)
        x_t2, x_s2, atts2 = bb(batch.x_t, batch.x_s, batch, return_atts=True)
    assert [s[0].shape[0] for s in snaps] == [batch.levels[0].num_nodes] + \
        [batch.levels[1].num_nodes] * 2
    torch.testing.assert_close(snaps[-1][0], x_t, rtol=0, atol=0)
    torch.testing.assert_close(x_s2, x_s, rtol=0, atol=0)
    assert len(atts) == len(atts2) == 1


# ---------------------------------------------------------------------------
# utils.viz
# ---------------------------------------------------------------------------


def test_viz_matrix_functions_equal_jax():
    rng = np.random.default_rng(11)
    src, dst, _, n = _skeleton(12, n=30, extra=50)
    att = rng.random(src.size).astype(np.float32)
    m = viz.attention_fc_matrix(torch.from_numpy(att), torch.from_numpy(src), dst, n)
    ref = jviz.attention_fc_matrix(att, src, dst, n)
    assert m.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(m, ref)
    parcels = rng.integers(0, 5, n)
    for a, b in zip(viz.sort_by_parcels(m, parcels), jviz.sort_by_parcels(ref, parcels)):
        np.testing.assert_array_equal(a, b)
    batch = jbuild.collate([jsynthetic.random_simplex_sample(np.random.default_rng(i))
                            for i in range(3)])
    ours = build.collate([synthetic.random_simplex_sample(np.random.default_rng(i))
                          for i in range(3)]).to("cpu")
    np.testing.assert_array_equal(viz.edge_index_from_level(ours.level0),
                                  jviz.edge_index_from_level(batch.level0))


def test_collect_outputs_on_a_graph_model_matches_jax():
    """Latents (the pooled readout), predictions and labels of two batches
    through ``HLHGCNNGraph(return_latent=True)``, against the JAX model's."""
    pairs = [_sample_pairs(50 + 10 * i, 3, 1) for i in range(2)]
    batches = [build.collate(o).to("cpu") for o, _ in pairs]
    jbatches = [jax.tree.map(jnp.asarray, jbuild.collate(r)) for _, r in pairs]
    kw = dict(channels=(1, 1), filters=(8, 16), k=2, mlp_channels=(8,), dropout=0.0)
    model, _ = presets.cifar10sp_attpool(**kw, in_t=batches[0].x_t.shape[-1],
                                         in_s=batches[0].x_s.shape[-1], seed=5, device="cpu")
    model.eval()
    jmodel, _ = jpresets.cifar10sp_attpool(**kw)
    v = _flax_variables(model)

    def apply(b):
        out, extras = model(b, return_latent=True)
        return extras["latent"], out

    def japply(b):
        out, extras = jmodel.apply(v, b, deterministic=True, return_latent=True)
        return extras["latent"], out

    with torch.inference_mode():
        ours = viz.collect_outputs(batches, apply)
    ref = jviz.collect_outputs(jbatches, japply)
    assert ours["latent"].shape == ref["latent"].shape == (6, 32)
    for key in ("latent", "pred"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=MODEL_ATOL)
    np.testing.assert_array_equal(ours["y"], ref["y"])


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------


def test_step_timer_counts_as_jax():
    t = profiling.StepTimer(edges_per_step=100)
    for _ in range(3):
        with t:
            pass
    s = t.summary()
    assert s["steps"] == 3 and list(s) == ["steps", "steps_per_sec", "edges_per_sec",
                                           "best_step_s"]
    assert t.edges_per_sec == pytest.approx(100 * t.steps_per_sec)
    assert profiling.StepTimer().summary()["best_step_s"] is None
    profiling.device_barrier({"a": torch.ones(2), "b": [torch.zeros(1)]})  # no card: nothing


def test_trace_context_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace_context(str(tmp_path)) as prof:
        (x @ x).sum()
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and len(prof.key_averages()) > 0


def test_nan_checks_raise_then_return_nan_when_off():
    profiling.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            torch.zeros(2) / torch.zeros(2)
        buf = torch.empty(1 << 12)  # allocation and views are not results
        buf[:4].fill_(1.0)
        with pytest.raises(FloatingPointError, match="laguerre_terms_dense"):
            nan_checks.check_kernel_outputs("laguerre_terms_dense", torch.tensor([float("nan")]))
    finally:
        profiling.enable_nan_checks(False)
    assert torch.isnan(torch.zeros(2) / torch.zeros(2)).all()
    nan_checks.check_kernel_outputs("laguerre_terms_dense", torch.tensor([float("nan")]))
