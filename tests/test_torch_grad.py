"""Gradients of the port against ``jax.grad`` of the JAX package (CPU).

Kernel level: the port's hand-derived plain backward versions (the CPU path
of the ``autograd.Function``s) against ``jax.vjp`` through the Pallas
kernels in interpret mode.  Model level: a narrow zinc_pyr's loss and every
parameter gradient on the three conv routes, in f32 and bf16, and the
reference-produced ``grad_zinc_pyr.npz`` fixture.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.nn import conv as jconv
from hl_hgat_tpu.nn.gemm import use_swap_dw
from hl_hgat_tpu.ops import pallas_hodge
from hl_hgat_tpu.ops.segment import embed_lookup as jembed_lookup
from hl_hgat_tpu.train.losses import l1_loss as jl1_loss
from hl_hgat_tpu_torch.complex.build import build_complex
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph
from hl_hgat_tpu_torch.nn import conv
from hl_hgat_tpu_torch.nn.gemm import stack_gemm
from hl_hgat_tpu_torch.ops import laguerre_dense as lg
from hl_hgat_tpu_torch.ops.segment import embed_lookup
from hl_hgat_tpu_torch.train.losses import l1_loss
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

F32 = dict(rtol=1e-5, atol=1e-5)  # same f32 arithmetic, summation order only
BF16_REL = 2e-2  # of max|ref|: a few bf16 ulps of the largest entries
# model-level f32 bounds of tests/test_reference_parity.py::_check_grads
MODEL = dict(rtol=2e-3, atol=1e-5)
# bf16 model-level gradients, relative to each leaf's max|ref|.  Measured on
# this narrow model: 2.3e-2 (plain), 2.9e-2 (fused), 2.5e-2 (terms) on the
# worst leaf; both sides round at the same places but reduce in other
# orders.  (JAX bf16 itself is up to 1.0 of max|ref| away from JAX f32.)
BF16_MODEL_REL = 6e-2
# A bias in front of a BatchNorm has a gradient of exactly zero (f32 gives
# ~1e-7); in bf16 both packages return rounding noise there, measured up to
# 2.2e-2, which is compared by size, not leaf against leaf.
BF16_ZERO_GRAD_NOISE = 5e-2

KERNEL_SHAPES = [(3, 16, 8, 8, 1), (3, 16, 12, 10, 3), (2, 32, 40, 24, 6)]


def _kernel_inputs(g, s, c, f, k, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g, s, s)).astype(np.float32)
    # symmetric positive semi-definite with spectrum in [0, 1], like a
    # rescaled Hodge Laplacian: the Laguerre terms stay O(1)
    l = a @ a.transpose(0, 2, 1) / (4 * s)
    x = rng.standard_normal((g, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c, f)).astype(np.float32) * 0.1
    b = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((g, s, f)).astype(np.float32)
    return l, x, w, b, cot


def _close(ours, ref, dtype, what=""):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, err_msg=what, **F32)
    else:
        np.testing.assert_allclose(
            ours, ref, rtol=0, atol=BF16_REL * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,s,c,f,k", KERNEL_SHAPES)
def test_fused_vjp_matches_pallas(dtype, g, s, c, f, k):
    l, x, w, b, cot = _kernel_inputs(g, s, c, f, k)
    td = getattr(torch, dtype)
    tl = torch.from_numpy(l).to(td).requires_grad_()
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = lg.laguerre_dense_fused(tl, tx, tw, tb)
    out.backward(torch.from_numpy(cot).to(td))
    assert tl.grad is None  # L is data
    assert tx.grad.dtype == td and tw.grad.dtype == tb.grad.dtype == torch.float32
    _, vjp = jax.vjp(
        pallas_hodge.laguerre_dense_fused, jnp.asarray(l, dtype),
        jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
    _, rdx, rdw, rdb = vjp(jnp.asarray(cot, dtype))
    _close(tx.grad, rdx, dtype, "dx")
    _close(tw.grad, rdw, dtype, "dw")
    _close(tb.grad, rdb, dtype, "db")


def test_fused_vjp_matches_pallas_over_two_channel_tiles():
    """C = 600, two channel tiles on the JAX side (float32)."""
    l, x, w, b, cot = _kernel_inputs(2, 16, 600, 8, 3)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    lg.laguerre_dense_fused(torch.from_numpy(l), tx, tw, tb).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(pallas_hodge.laguerre_dense_fused, *(jnp.asarray(a) for a in (l, x, w, b)))
    _, rdx, rdw, rdb = vjp(jnp.asarray(cot))
    _close(tx.grad, rdx, "float32", "dx")
    _close(tw.grad, rdw, "float32", "dw")
    _close(tb.grad, rdb, "float32", "db")


@pytest.mark.parametrize("k", [9, 10])
def test_fused_conv_gradients_beyond_eight_terms_match_jax_grad(k):
    """K = 9 and 10, beyond the 8 terms the card's fused backward holds at
    once: the fused conv's gradients against ``jax.grad`` through the JAX
    kernel (float32, the model-level bounds)."""
    l, x, w, b, cot = _kernel_inputs(2, 16, 12, 10, k)
    prev = conv.use_fused_dense()
    try:
        conv.use_fused_dense(True)
        m = conv.LaguerreConv(12, 10, k)
        m.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
        tx = torch.from_numpy(x).requires_grad_()
        (m(tx, torch.from_numpy(l)) * torch.from_numpy(cot)).sum().backward()
    finally:
        conv.use_fused_dense(prev)
    rdx, rdw, rdb = jax.grad(
        lambda xx, ww, bb: jnp.sum(pallas_hodge.laguerre_dense_fused(jnp.asarray(l), xx, ww, bb)
                                   * cot), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for ours, ref, name in ((tx.grad, rdx, "dx"), (m.weight.grad, rdw, "dw"),
                            (m.bias.grad, rdb, "db")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=name, **MODEL)


@pytest.mark.parametrize("g,s,c,f,k", KERNEL_SHAPES)
def test_fused_plain_backward_matches_autograd_of_plain_forward(g, s, c, f, k):
    """Same math, other association (adjoint walk vs reverse-mode through
    the recurrence): rtol 1e-4."""
    l, x, w, b, cot = (torch.from_numpy(a) for a in _kernel_inputs(g, s, c, f, k))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = torch.autograd.grad(
        lg.laguerre_dense_fused_plain(l, *leaves), leaves, cot)
    got = lg.laguerre_dense_fused_bwd_plain(l, x, w, cot)
    for a, r, name in zip(got, ref, ("dx", "dw", "db")):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# K = 10: the card's terms backward streams the walk and takes any K, as the
# JAX kernel does
@pytest.mark.parametrize("g,s,c,k", [(3, 16, 8, 2), (3, 16, 12, 3), (2, 32, 40, 6), (2, 16, 8, 10)])
def test_terms_vjp_matches_pallas(dtype, g, s, c, k):
    l, x, _, _, _ = _kernel_inputs(g, s, c, 1, k)
    dt = np.random.default_rng(1).standard_normal((k, g, s, c)).astype(np.float32)
    td = getattr(torch, dtype)
    tl = torch.from_numpy(l).to(td).requires_grad_()
    tx = torch.from_numpy(x).to(td).requires_grad_()
    lg.laguerre_terms_dense(tl, tx, k).backward(torch.from_numpy(dt).to(td))
    assert tl.grad is None and tx.grad.dtype == td
    _, vjp = jax.vjp(
        lambda ll, xx: pallas_hodge.laguerre_terms_dense(ll, xx, k),
        jnp.asarray(l, dtype), jnp.asarray(x, dtype))
    _, rdx = vjp(jnp.asarray(dt, dtype))
    _close(tx.grad, rdx, dtype, "dx")
    if dtype == "float32":
        xa = torch.from_numpy(x).requires_grad_()
        (auto,) = torch.autograd.grad(
            lg.laguerre_terms_dense_plain(torch.from_numpy(l), xa, k), xa,
            torch.from_numpy(dt))
        torch.testing.assert_close(tx.grad, auto, rtol=1e-4, atol=1e-5)


def test_cpu_backward_counts_no_launch():
    l, x, w, b, cot = (torch.from_numpy(a) for a in _kernel_inputs(2, 16, 8, 8, 3))
    lg.reset_launch_counts()
    x.requires_grad_()
    lg.laguerre_dense_fused(l, x, w, b).backward(cot)
    lg.laguerre_terms_dense(l, x, 3).sum().backward()
    assert lg.LAUNCHES == {
        "laguerre_dense_fused": 0, "laguerre_terms_dense": 0,
        "laguerre_dense_fused_bwd": 0, "laguerre_terms_dense_bwd": 0}


def test_embed_lookup_gradient_matches_jax_and_torch_gather(rng):
    table = rng.standard_normal((28, 5)).astype(np.float32)
    ids = rng.integers(0, 28, (3, 40))  # 120 lookups into 28 rows: repeats
    ids[0, :7] = 3
    cot = rng.standard_normal((3, 40, 5)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    out = embed_lookup(t, torch.from_numpy(ids))
    assert torch.equal(out, t.detach()[torch.from_numpy(ids)])
    out.backward(torch.from_numpy(cot))
    ref = jax.grad(lambda tb: jnp.sum(jembed_lookup(tb, jnp.asarray(ids)) * cot))(
        jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), ref, **F32)
    t2 = torch.from_numpy(table).requires_grad_()
    t2[torch.from_numpy(ids)].backward(torch.from_numpy(cot))
    torch.testing.assert_close(t.grad, t2.grad, rtol=1e-6, atol=1e-6)


def test_stack_gemm_bf16_backward_keeps_dw_in_f32(rng):
    """The settled bf16 semantics: both contractions in f32, dW not rounded
    to bf16, dx rounded once (the JAX ``use_swap_dw(True)`` form)."""
    x = rng.standard_normal((2, 16, 12)).astype(np.float32)
    w = rng.standard_normal((12, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 6)).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    stack_gemm(tx, tw).backward(torch.from_numpy(cot))
    from hl_hgat_tpu.nn.gemm import stack_gemm as jstack_gemm

    prev = use_swap_dw()
    try:
        use_swap_dw(True)
        _, vjp = jax.vjp(jstack_gemm, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
        rdx, rdw = vjp(jnp.asarray(cot))
    finally:
        use_swap_dw(prev)
    assert tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(tw.grad.numpy(), rdw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(rdx, np.float32),
                               rtol=0, atol=1e-2 * np.abs(np.asarray(rdx, np.float32)).max())
    # dW carries more than bf16's 8 bits of mantissa
    assert not torch.equal(tw.grad, tw.grad.bfloat16().float())


# ---------------------------------------------------------------------------
# the slice as a whole: narrow zinc_pyr, one train-mode forward/backward
# ---------------------------------------------------------------------------

NARROW = dict(channels=(1, 1), filters=(16, 32), k=3, keig=15, mlp_channels=(16,))
ROUTES = {"plain": (False, False), "fused": (True, False), "terms": (False, True)}


class _routes:
    """Set the conv route in both packages, restore on exit."""

    def __init__(self, route):
        self.flags = ROUTES[route]

    def __enter__(self):
        self.prev = (conv.use_fused_dense(), conv.use_terms_kernel(),
                     jconv.use_fused_dense(), jconv.use_terms_kernel())
        for mod in (conv, jconv):
            mod.use_fused_dense(self.flags[0])
            mod.use_terms_kernel(self.flags[1])

    def __exit__(self, *exc):
        conv.use_fused_dense(self.prev[0])
        conv.use_terms_kernel(self.prev[1])
        jconv.use_fused_dense(self.prev[2])
        jconv.use_terms_kernel(self.prev[3])


@pytest.fixture(scope="module")
def narrow():
    samples = zinc_like_samples(np.random.default_rng(21), 12)
    batch = collate_dense_packed(samples).to("cpu")
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples))
    jmodel, _ = jpresets.zinc_pyr(**NARROW)
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jbatch, deterministic=True))
    return batch, jbatch, jmodel, v


def _jax_loss_and_grads(jmodel, v, jbatch):
    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jbatch,
            deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)})
        return jl1_loss(out.reshape(-1), jbatch.y.reshape(-1))

    loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    flat = {tuple(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat


def _port_loss_and_grads(v, batch, **kw):
    model, _ = presets.zinc_pyr(**NARROW, device="cpu", **kw)
    model.load_state_dict(from_flax_variables(v))
    model.train()
    loss = l1_loss(model(batch).reshape(-1), batch.y.reshape(-1))
    loss.backward()
    grads = to_flax_paths(model, {n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), grads


@pytest.mark.parametrize("route", list(ROUTES))
def test_narrow_zinc_pyr_gradients_match_jax(narrow, route):
    batch, jbatch, jmodel, v = narrow
    with _routes(route):
        ref_loss, ref = _jax_loss_and_grads(jmodel, v, jbatch)
        loss, grads = _port_loss_and_grads(v, batch)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert set(grads) == set(ref)
    for path in sorted(ref):
        assert np.abs(ref[path]).max() > 0, path
        np.testing.assert_allclose(grads[path], ref[path], err_msg="/".join(path), **MODEL)


@pytest.mark.parametrize("route", list(ROUTES))
def test_narrow_zinc_pyr_bf16_gradients_track_jax_bf16(narrow, route):
    batch, jbatch, jmodel, v = narrow
    jm16 = dataclasses.replace(
        jmodel, cfg=dataclasses.replace(jmodel.cfg, compute_dtype="bfloat16"))
    prev = use_swap_dw()
    try:
        use_swap_dw(True)  # the JAX bf16 recipe; the port's only formulation
        with _routes(route):
            ref_loss, ref = _jax_loss_and_grads(jm16, v, jbatch)
            loss, grads = _port_loss_and_grads(v, batch, compute_dtype="bfloat16")
            _, grads32 = _port_loss_and_grads(v, batch)
    finally:
        use_swap_dw(prev)
    assert loss == pytest.approx(ref_loss, rel=2e-2)
    assert set(grads) == set(ref)
    worst, zero_leaves = 0.0, 0
    for path in sorted(ref):
        if np.abs(grads32[path]).max() < 1e-5:  # exactly zero in exact arithmetic
            zero_leaves += 1
            assert path[-1] == "bias", path
            assert np.abs(grads[path]).max() <= BF16_ZERO_GRAD_NOISE, "/".join(path)
            continue
        scale = np.abs(ref[path]).max()
        err = np.abs(grads[path] - ref[path]).max()
        worst = max(worst, err / scale)
        assert err <= BF16_MODEL_REL * scale, ("/".join(path), err / scale)
    assert 0 < zero_leaves < len(ref) // 2
    print(f"bf16 {route}: worst leaf error {worst:.3e} of max|ref|")


# ---------------------------------------------------------------------------
# gradient fixture produced by the reference code (torch autograd through
# the reference backward, tests/golden/reference/grad_zinc_pyr.npz)
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "reference", "grad_zinc_pyr.npz")


def _translated(fx, prefix):
    """Reference state-dict names → flax paths, through the JAX package's
    importer table (a module that imports no JAX)."""
    from hl_hgat_tpu_torch.utils.torch_import import _translate_hgcnn

    entries, _ = _translate_hgcnn(
        {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}, head="graph")
    return entries


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="reference fixtures not generated")
@pytest.mark.parametrize("route", list(ROUTES))
def test_grad_zinc_pyr_fixture(route):
    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    n_off = np.concatenate([[0], np.cumsum(fx["num_node1"].astype(int))])
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    ei = fx["in/edge_index"]
    samples = []
    for g in range(len(n_off) - 1):
        cols = (ei[0] >= n_off[g]) & (ei[0] < n_off[g + 1])
        samples.append(build_complex(
            ei[:, cols] - n_off[g], int(n_off[g + 1] - n_off[g]),
            x_t=fx["in/x_t"][n_off[g]:n_off[g + 1]],
            x_s=fx["in/x_s"][e_off[g]:e_off[g + 1]], y=fx["y"][g]))
    batch = collate_dense_packed(samples).to("cpu")

    variables = {"params": {}, "batch_stats": {}}
    for (col, path), val in _translated(fx, "sd/").items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    cfg = BackboneConfig(channels=(2, 2), filters=(8, 16), k=3, init_k=3, deg_eps=0.0)
    model = HLHGCNNGraph(cfg, fx["in/x_t"].shape[1], fx["in/x_s"].shape[1],
                         mlp_channels=(), num_classes=1)
    model.load_state_dict(from_flax_variables(variables))
    model.train()
    with _routes(route):
        loss = l1_loss(model(batch).reshape(-1, 1), batch.y.reshape(-1, 1))
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=1e-5)
    grads = to_flax_paths(model, {n: p.grad for n, p in model.named_parameters()})
    ref = {path: v for (col, path), v in _translated(fx, "gd/").items() if col == "params"}
    assert set(grads) == set(ref)
    for path in sorted(ref):
        np.testing.assert_allclose(grads[path], ref[path], err_msg="/".join(path), **MODEL)
