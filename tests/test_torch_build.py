"""Port's NumPy builders and packed collate vs the JAX package's, field by
field (exact: both run the same NumPy arithmetic)."""

import numpy as np
import pytest

from hl_hgat_tpu.complex import build as jbuild
from hl_hgat_tpu.complex import dense as jdense
from hl_hgat_tpu.data import synthetic as jsynth
from hl_hgat_tpu_torch.complex import build, dense
from hl_hgat_tpu_torch.data import synthetic


def _assert_structure_equal(a, b):
    for f in ("src", "dst", "l0_rows", "l0_cols", "l0_vals", "l1_rows",
              "l1_cols", "l1_vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.num_nodes, a.num_edges, a.max_eig) == (b.num_nodes, b.num_edges, b.max_eig)


def _assert_sample_equal(a, b):
    np.testing.assert_array_equal(a.x_t, b.x_t)
    np.testing.assert_array_equal(a.x_s, b.x_s)
    np.testing.assert_array_equal(a.y, b.y)
    assert len(a.levels) == len(b.levels) == 1
    _assert_structure_equal(a.levels[0], b.levels[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_complex_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 14
    ei = rng.integers(0, n, (2, 40))  # duplicates, both orientations, self-loops
    attr = rng.standard_normal((40, 2)).astype(np.float32)
    for reduce in ("min", "mean"):
        ours = build.canonical_undirected(ei, attr, reduce=reduce)
        ref = jbuild.canonical_undirected(ei, attr, reduce=reduce)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
    xt = rng.standard_normal((n, 3)).astype(np.float32)
    _assert_sample_equal(
        build.build_complex(ei, n, x_t=xt, edge_attr=attr, keig=6),
        jbuild.build_complex(ei, n, x_t=xt, edge_attr=attr, keig=6),
    )


def test_laplacian_helpers_match_jax(rng):
    src, dst = synthetic._random_connected(rng, 12, 5)
    l0, l1, lam = build.hodge_laplacians(src, dst, 12)
    j0, j1, jlam = jbuild.hodge_laplacians(src, dst, 12)
    np.testing.assert_array_equal(l0, j0)
    np.testing.assert_array_equal(l1, j1)
    assert lam == jlam
    np.testing.assert_array_equal(build.boundary_dense(src, dst, 12),
                                  jbuild.boundary_dense(src, dst, 12))
    for a, b in zip(build.dense_to_coo(l1), jbuild.dense_to_coo(j1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(build.eig_pe(l0, k=20), jbuild.eig_pe(j0, k=20))


def test_graphs_over_1024_edges_take_the_sparse_direct_build(monkeypatch):
    """``build_structure`` leaves the dense build to graphs of at most
    ``SPARSE_BUILD_THRESHOLD`` edges: a 1099-edge graph builds with the dense
    build made to raise, through the sparse-direct build, and gives the JAX
    package's entries and λmax."""
    n = 1100
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    ref = jbuild.build_structure(src, dst, n)

    def refuse(*args):
        raise AssertionError("dense build taken above the threshold")

    monkeypatch.setattr(build, "hodge_laplacians", refuse)
    ours = build.build_structure(src, dst, n)
    for which in ("l0", "l1"):
        key = lambda st: np.lexsort((getattr(st, f"{which}_cols"),  # noqa: E731
                                     getattr(st, f"{which}_rows")))
        for f in ("rows", "cols", "vals"):
            a = getattr(ours, f"{which}_{f}")[key(ours)]
            b = getattr(ref, f"{which}_{f}")[key(ref)]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f"{which}_{f}")
    assert ours.max_eig == pytest.approx(ref.max_eig, rel=1e-6)


def test_generators_match_jax():
    ours = synthetic.random_simplex_sample(np.random.default_rng(3), keig=5)
    ref = jsynth.random_simplex_sample(np.random.default_rng(3), keig=5)
    _assert_sample_equal(ours, ref)
    # zinc_like_samples is the generator bench.py inlines (bench.py:137-147)
    rng = np.random.default_rng(4)
    expect = []
    for _ in range(6):
        n = int(rng.integers(15, 33))
        s = jsynth.random_simplex_sample(
            rng, n_nodes=n, extra_edges=int(rng.integers(2, 6)),
            node_feat=1, edge_feat=1, keig=16,
        )
        s.x_t[:, 0] = rng.integers(0, 28, s.x_t.shape[0])
        s.x_s[:, 0] = rng.integers(0, 4, s.x_s.shape[0])
        expect.append(s)
    for a, b in zip(synthetic.zinc_like_samples(np.random.default_rng(4), 6), expect):
        _assert_sample_equal(a, b)
        assert a.x_t.shape[1] == 16


@pytest.mark.parametrize("count,cap", [(40, 128), (13, 64)])
def test_collate_dense_packed_matches_jax(count, cap):
    samples = synthetic.zinc_like_samples(np.random.default_rng(count), count)
    bins, spans = dense.pack_plan(samples, cap, cap)
    jbins, jspans = jdense.pack_plan(samples, cap, cap, allow_span=False)
    assert bins == jbins and spans == jspans == {}
    ours = dense.collate_dense_packed(samples, node_cap=cap, edge_cap=cap)
    ref = jdense.collate_dense_packed(samples, node_cap=cap, edge_cap=cap)
    for f in ("x_t", "x_s", "y"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert ours.num_graphs == ref.num_graphs == count
    lo, lr = ours.level0, ref.levels[0]
    for f in ("l0", "l1", "b1", "node_mask", "edge_mask", "deg", "n_gid", "s_gid"):
        np.testing.assert_array_equal(getattr(lo, f), getattr(lr, f), err_msg=f)
    assert lo.num_graphs == lr.num_graphs


def test_collate_refuses_graphs_over_the_caps():
    """A plan without spans refuses a graph over the caps, and so does the
    serving collate; the default plan spans blocks instead (spill mode,
    ``tests/test_torch_spill.py``)."""
    from hl_hgat_tpu_torch.models import presets
    from hl_hgat_tpu_torch.serving import Predictor

    samples = synthetic.zinc_like_samples(np.random.default_rng(5), 8)
    with pytest.raises(ValueError, match="exceeds pack caps"):
        dense.pack_plan(samples, 16, 16, allow_span=False)
    with pytest.raises(ValueError, match="exceeds pack caps"):
        dense.pack_plan(samples, 128, 8, allow_span=False)
    model, _ = presets.zinc_pyr(channels=(1,), filters=(16,), k=2, keig=15, mlp_channels=(8,),
                                device="cpu")
    with pytest.raises(ValueError, match="exceeds pack caps"):
        Predictor(model, node_cap=16, edge_cap=16, device="cpu").collate(samples)
    assert dense.pack_plan(samples, 16, 16)[1]


def test_batch_to_device_gives_tensors():
    import torch

    samples = synthetic.zinc_like_samples(np.random.default_rng(6), 3)
    batch = dense.collate_dense_packed(samples).to("cpu")
    assert isinstance(batch.x_t, torch.Tensor) and batch.x_t.dtype == torch.float32
    assert batch.level0.n_gid.dtype == torch.int32
    assert batch.level0.num_graphs == batch.num_graphs == 3
