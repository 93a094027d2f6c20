"""The port's host library (``hl_hgat_tpu_torch/native.py``) against the JAX
package's binding of the same C++ source: each of the nine shared entry
points on the same inputs, exact; the port's own ``ffd_pack`` declared (its
bins are tested through ``pack_indices`` in ``test_torch_data.py``); the build
of both sources into the port's own ``_build/`` (never a library of
``native/``), its hash, its failure with the compiler's log; and the two
callers in ``complex/build.py`` against their NumPy versions."""

import ctypes
import pathlib

import numpy as np
import pytest

from hl_hgat_tpu import native as jnative
from hl_hgat_tpu.complex import build as jbuild
from hl_hgat_tpu_torch import native
from hl_hgat_tpu_torch.complex import build
from hl_hgat_tpu_torch.data.fast_collate import FlatSamples, _placements, pack_indices
from hl_hgat_tpu_torch.data.synthetic import knn_graph, random_simplex_sample

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def libs():
    ref = jnative.load()
    if ref is None:  # the JAX package builds its library with make at first use
        pytest.fail("the JAX package's native library did not build")
    return native.load(), ref


def _graph(seed, n=60, extra=40):
    rng = np.random.default_rng(seed)
    src, dst = knn_graph(rng, n, k=4)[0]
    keep = rng.random(src.shape[0]) < 0.9
    src, dst = src[keep][: n + extra], dst[keep][: n + extra]
    return np.ascontiguousarray(src, np.int32), np.ascontiguousarray(dst, np.int32), n


def _packed_args(which):
    """The arguments of one packed fill for a pooled batch (outputs zeroed;
    the gid tables prefilled with the dump id), as fast_collate builds them."""
    rng = np.random.default_rng(3)
    samples = [random_simplex_sample(rng, n_nodes=int(rng.integers(10, 20)), node_feat=3,
                                     edge_feat=2, keig=4, num_pool=1) for _ in range(12)]
    flat = FlatSamples(samples)
    idx = np.arange(12, dtype=np.int64)[::-1].copy()
    pl = _placements(flat, idx, pack_indices(flat, idx, 48, 56), 48, 56, None, [(48, 56)])
    nb, n = pl.nb, len(pl.sample_idx)
    (s0, e0), (s1, e1) = pl.caps
    fl = flat.levels[0]
    if which == "packed_fill_level":
        out = [np.zeros(shape, np.float32) for shape in
               ((nb, s0, s0), (nb, e0, e0), (nb, s0, e0), (nb, s0), (nb, e0), (nb, s0))]
        out += [np.full((nb, s0), 12, np.int32), np.full((nb, e0), 12, np.int32)]
        args = [n, pl.sample_idx, pl.bin_of, pl.offs_n[0], pl.offs_e[0], fl.num_nodes,
                fl.num_edges, fl.l0_off, fl.l0_rows, fl.l0_cols, fl.l0_vals, fl.l1_off,
                fl.l1_rows, fl.l1_cols, fl.l1_vals, fl.e_off, fl.src, fl.dst, pl.gid, s0, e0]
        return args + out, out
    if which == "packed_fill_rows":
        out = np.zeros((nb, e0, flat.x_s.shape[1]), np.float32)
        return [n, pl.sample_idx, pl.bin_of, pl.offs_e[0], fl.e_off, flat.x_s,
                flat.x_s.shape[1], e0, out], [out]
    out = [np.zeros((nb, s1, s0), np.float32), np.zeros((nb, e1, e0), np.float32)]
    args = [n, pl.sample_idx, pl.bin_of, pl.offs_n[0], pl.offs_e[0], pl.offs_n[1],
            pl.offs_e[1], flat.cn_off[0], flat.c_node[0], flat.ce_off[0], flat.c_edge[0],
            nb, s1, s0, e1, e0]
    return args + out, out


def _call(lib, name):
    """(return value, output arrays) of one entry point on fixed inputs."""
    src, dst, n = _graph(1)
    e = src.shape[0]
    if name == "graclus_match":
        w = np.random.default_rng(2).random(e).astype(np.float32)
        outs = [np.empty(n, np.int64), np.empty(n, np.int64)]
        lib.graclus_match(n, e, src, dst, w.ctypes.data_as(ctypes.c_void_p), outs[0])
        lib.graclus_match(n, e, src, dst, None, outs[1])
        return None, outs
    if name == "coarse_edges":
        c_node = np.ascontiguousarray(np.arange(n) // 2, np.int64)
        # only the first (returned count) coarse endpoints are written
        outs = [np.zeros(e, np.int32), np.zeros(e, np.int32), np.empty(e, np.int64)]
        return lib.coarse_edges(e, src, dst, c_node, *outs), outs
    if name in ("hodge_l1", "l1_pair_count"):
        cap = int(lib.l1_pair_count(n, e, src, dst))
        if name == "l1_pair_count":
            return cap, []
        outs = [np.zeros(cap, np.int32), np.zeros(cap, np.int32), np.zeros(cap, np.float32)]
        return lib.hodge_l1(n, e, src, dst, 0.3, *outs), outs
    rows, cols = np.nonzero(np.random.default_rng(4).random((40, 40)) < 0.2)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    vals = np.random.default_rng(5).standard_normal(rows.size).astype(np.float32)
    vals[::7] = 0.0
    if name == "max_row_nnz":
        return lib.max_row_nnz(rows.size, rows, vals, 40), []
    if name == "coo_to_ell":
        outs = [np.empty((40, 16), np.int32), np.empty((40, 16), np.float32)]
        rc = lib.coo_to_ell(rows.size, rows, cols, vals, 40, 16, *outs)
        too_narrow = lib.coo_to_ell(rows.size, rows, cols, vals, 40, 2,
                                    np.empty((40, 2), np.int32), np.empty((40, 2), np.float32))
        return (rc, too_narrow), outs
    args, outs = _packed_args(name)
    return getattr(lib, name)(*args), outs


ENTRY_POINTS = ["graclus_match", "coarse_edges", "coo_to_ell", "max_row_nnz", "hodge_l1",
                "l1_pair_count", "packed_fill_level", "packed_fill_rows", "packed_fill_pool"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_matches_the_jax_binding(libs, name):
    ours, ref = (_call(lib, name) for lib in libs)
    assert ours[0] == ref[0]
    assert len(ours[1]) == len(ref[1])
    for a, b in zip(ours[1], ref[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert any(np.any(a) for a in ours[1]) or ours[0]


def test_every_entry_point_is_declared(libs):
    lib = libs[0]
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        assert fn.argtypes is not None, name
    assert len(ENTRY_POINTS) == 9


def test_library_is_built_into_the_ports_own_directory(libs):
    path = native.library_path()
    assert path.parent == ROOT / "hl_hgat_tpu_torch" / "_build"
    assert path.name.startswith("libhlhgat_native-") and path.exists()
    assert libs[0]._name == str(path)
    assert native.build() == 0.0  # built once, then found
    # the port's copy of the source carries the same code
    ours = native.SOURCE.read_text()
    ref = (ROOT / "native" / "hlhgat_native.cpp").read_text()
    assert ours[ours.index("#include <algorithm>"):] == ref[ref.index("#include <algorithm>"):]


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.library_path.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp") as err:
            native.build()
        assert "error" in str(err.value)
        assert not list((tmp_path / "_build").glob("*"))  # no half-built file left
    finally:
        monkeypatch.undo()
        native.library_path.cache_clear()


def test_ffd_pack_is_declared(libs):
    fn = libs[0].ffd_pack
    assert fn.argtypes is not None and len(fn.argtypes) == 9
    assert fn.restype is ctypes.c_int64


@pytest.mark.parametrize("edited", ["SOURCE", "PACK_SOURCE"])
def test_both_sources_feed_the_library_hash(tmp_path, monkeypatch, edited):
    for name in ("SOURCE", "PACK_SOURCE"):
        copy = tmp_path / getattr(native, name).name
        copy.write_bytes(getattr(native, name).read_bytes())
        monkeypatch.setattr(native, name, copy)
    native.library_path.cache_clear()
    try:
        before = native.library_path()
        src = getattr(native, edited)
        src.write_text(src.read_text() + "// edited\n")
        native.library_path.cache_clear()
        after = native.library_path()
        assert after != before and after.parent == before.parent
        assert after.name.startswith("libhlhgat_native-")
    finally:
        monkeypatch.undo()
        native.library_path.cache_clear()
    assert native.library_path().name != after.name


def test_hodge_laplacians_coo_takes_the_native_l1():
    """Above the dense threshold the port's build gives the JAX build's
    arrays (both take the native L1); the NumPy L1 stays within rounding."""
    ei, _ = knn_graph(np.random.default_rng(0), 300)
    src, dst = ei[0].astype(np.int32), ei[1].astype(np.int32)
    (l0r, l0c, l0v), l1, lam = build.hodge_laplacians_coo(src, dst, 300)
    (j0r, j0c, j0v), j1, jlam = jbuild.hodge_laplacians_coo(src, dst, 300)
    # λmax comes from Lanczos in both (its start vector is random)
    np.testing.assert_allclose(lam, jlam, rtol=1e-6)
    for ours, ref in (((l0r, l0c, l0v), (j0r, j0c, j0v)), (l1, j1)):
        for a, b in zip(ours, ref):
            assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_allclose(ours[2], ref[2], rtol=1e-6)
    np.testing.assert_array_equal(l1[2], native.hodge_l1(src, dst, 300, 2.0 / lam)[2])
    r, c, v = build.hodge_l1_numpy(src, dst, 300, 2.0 / lam)
    np.testing.assert_array_equal(r, l1[0])
    np.testing.assert_array_equal(c, l1[1])
    # float64 scale there, float32 here: at most one rounding apart
    np.testing.assert_allclose(v, l1[2], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("width", [None, 9])
def test_coo_to_ell_is_native_and_equals_its_numpy_version(width):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 30, 200).astype(np.int32)
    cols = rng.integers(0, 30, 200).astype(np.int32)
    vals = rng.standard_normal(200).astype(np.float32)
    vals[::6] = 0.0
    ours = build.coo_to_ell(rows, cols, vals, 30, width=None if width is None else 20)
    ref = build.coo_to_ell_numpy(rows, cols, vals, 30, width=None if width is None else 20)
    jref = jnative.coo_to_ell(rows, cols, vals, 30, None if width is None else 20)
    for a, b, c in zip(ours, ref, jref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if width is not None:
        with pytest.raises(ValueError, match="exceeds ELL width"):
            build.coo_to_ell(rows, cols, vals, 30, width=width)
        with pytest.raises(ValueError, match="exceeds ELL width"):
            build.coo_to_ell_numpy(rows, cols, vals, 30, width=width)
