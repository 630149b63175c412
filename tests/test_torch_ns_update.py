"""The port's NS update, Algorithm 1 and solver registry against the JAX
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's ``fused_ns_update`` runs the kernel's plain version; the reference
runs its Pallas kernel in interpret mode and its jnp oracle. Tolerances are
``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2), scaled by n for the
n-term sum as that file does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro.kernels.ns_update.ns_update import ns_update_nd
from repro.kernels.ns_update.ops import make_update_fn as jax_make_update_fn
from repro.kernels.ns_update.ref import ns_update_ref as jax_ns_update_ref
from repro.solvers import registry as jreg
from repro_torch.core import ns_solver as tns
from repro_torch.core import solvers as tsolvers
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import fm_ot
from repro_torch.core.taxonomy import run_direct, to_ns
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.kernels.ns_update.ns_update import ns_update
from repro_torch.kernels.ns_update.ops import fused_ns_update, make_update_fn
from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref, ns_update_ref
from repro_torch.solvers import registry as treg

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GENERIC = ("euler", "midpoint", "heun", "rk4", "ab2", "ab4")


def _inputs(seed, n, shape, dtype):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((n,) + shape).astype(np.float32)
    a = np.float32(rng.standard_normal())
    w = rng.standard_normal(n).astype(np.float32)
    jx = (jnp.asarray(x0).astype(dtype), jnp.asarray(u).astype(dtype),
          jnp.asarray(a), jnp.asarray(w))
    tdt = getattr(torch, dtype)
    tx = (torch.from_numpy(x0).to(tdt), torch.from_numpy(u).to(tdt),
          torch.tensor(a), torch.from_numpy(w))
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,B,D", [(4, 8, 512), (8, 2, 1024), (16, 4, 384),
                                   (20, 1, 128), (8, 3, 1000), (5, 2, 7)])
def test_fused_ns_update_matches_reference(n, B, D, dtype):
    jx, tx = _inputs(n * 1000 + B + D, n, (B, D), dtype)
    out = fused_ns_update(*tx)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, D)
    for ref in (ns_update_nd(*jx, interpret=True), jax_ns_update_ref(*jx)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype] * n,
                                   rtol=TOL[dtype])


def test_fused_ns_update_latent_sequence_shape():
    """(B, S, C) latents, as the flow sampler hands them over."""
    jx, tx = _inputs(0, 8, (2, 24, 16), "float32")
    np.testing.assert_allclose(fused_ns_update(*tx).numpy(),
                               np.asarray(ns_update_nd(*jx, interpret=True)),
                               atol=TOL["float32"] * 8, rtol=TOL["float32"])


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    _, (x0, u, a, w) = _inputs(1, 3, (2, 8), "float32")
    before = nu_mod.COUNTER.launches
    np.testing.assert_array_equal(make_update_fn()(x0, u, a, w).numpy(),
                                  ns_update_ref(x0, u, a, w).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ns_update(x0, u, a, w)
    assert nu_mod.COUNTER.launches == before


@pytest.mark.parametrize("bad", ["a", "w"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_kernel_wrapper_refuses_non_f32_coefficients_before_any_launch(bad, dtype):
    """The kernel reads a and w as f32 on the card; other types are refused
    before the device check and before any launch (ns_sample converts them
    once), while the plain version keeps taking any type."""
    _, (x0, u, a, w) = _inputs(2, 4, (2, 8), "float32")
    args = {"a": a, "w": w}
    args[bad] = args[bad].to(dtype)
    before = nu_mod.COUNTER.launches
    with pytest.raises(TypeError, match="float32 a and w"):
        ns_update(x0, u, **args)
    assert nu_mod.COUNTER.launches == before
    np.testing.assert_allclose(fused_ns_update(x0, u, **args).numpy(),
                               ns_update_ref(x0, u, a, w).numpy(),
                               atol=TOL["bfloat16"] if dtype == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("name,nfe", [("euler", 4), ("rk4", 8), ("ab2", 6)])
def test_ns_sample_hands_each_step_only_its_live_rows(name, nfe):
    """Under torch.no_grad() (how every serving engine samples), step i gets
    U[:i+1] and b[i, :i+1] as views of the solver's buffers (no copy, no mask
    launch), f32 coefficients, and the result equals the full-buffer form
    with masked weights."""
    params = treg.build_ns(name, nfe, None)
    x0 = torch.from_numpy(np.random.default_rng(nfe).standard_normal((3, 5)).astype(np.float32))
    seen = []

    def spy(x0_, U, a_i, w_i):
        seen.append((U, a_i, w_i))
        return fused_ns_update(x0_, U, a_i, w_i)

    with torch.no_grad():
        got = tns.ns_sample(params, _linear_u_np, x0, update_fn=spy)
    assert len(seen) == nfe
    b = torch.where(tns.tril_mask(nfe), params.b, 0.0).to(torch.float32)
    buffer = seen[-1][0]
    for i, (U, a_i, w_i) in enumerate(seen):
        assert U.shape == (i + 1,) + tuple(x0.shape) and w_i.shape == (i + 1,)
        assert U.data_ptr() == buffer.data_ptr() and U.is_contiguous()
        assert a_i.dtype == w_i.dtype == torch.float32 and a_i.numel() == 1
        np.testing.assert_array_equal(w_i.numpy(), b[i, : i + 1].numpy())
        np.testing.assert_array_equal(U.numpy(), buffer[: i + 1].numpy())
    # the reference's form: the whole buffer, weights past step i masked to zero
    x = x0
    full = torch.zeros((nfe,) + tuple(x0.shape))
    for i in range(nfe):
        full[i] = _linear_u_np(params.times[i], x)
        w = torch.where(torch.arange(nfe) <= i, b[i], 0.0)
        x = ns_update_ref(x0, full, params.a[i], w)
    np.testing.assert_allclose(got.numpy(), x.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,nfe", [("euler", 4), ("rk4", 8), ("ab2", 6)])
def test_ns_sample_under_grad_hands_each_step_fresh_live_rows(name, nfe):
    """With grad enabled nothing is written in place: step i gets i + 1 rows
    stacked anew (no view of an earlier step's rows, which that step's update
    saved for backward), and the same values and result as under no_grad."""
    params = treg.build_ns(name, nfe, None)
    x0 = torch.from_numpy(np.random.default_rng(nfe).standard_normal((3, 5)).astype(np.float32))
    seen = []

    def spy(x0_, U, a_i, w_i):
        seen.append(U)
        return fused_ns_update(x0_, U, a_i, w_i)

    got = tns.ns_sample(params, _linear_u_np, x0, update_fn=spy)
    with torch.no_grad():
        want = tns.ns_sample(params, _linear_u_np, x0)
    assert [U.shape[0] for U in seen] == list(range(1, nfe + 1))
    assert len({U.data_ptr() for U in seen}) == nfe
    for i, U in enumerate(seen[:-1]):
        np.testing.assert_array_equal(U.numpy(), seen[-1][: i + 1].numpy())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name,nfe", [("euler", 4), ("rk4", 8), ("midpoint", 8)])
def test_ns_sample_gradient_matches_jax_grad(name, nfe):
    """The port's ns_sample is reverse-mode differentiable in a and b, as the
    reference's is: d loss / d(a, b) against jax.grad of the reference on the
    same x0, solver and linear field, f32, TOL scaled by n."""
    import jax

    x0 = np.random.default_rng(nfe + 7).standard_normal((4, 6)).astype(np.float32)
    jfield = jtoy.linear_field(jsched.fm_ot())
    jp = jreg.build_ns(name, nfe, jfield)

    def jloss(a, b):
        x = jns.ns_sample(jns.NSParams(jp.times, a, b), jfield.fn, jnp.asarray(x0))
        return jnp.sum(x * x)

    ja, jb = jax.grad(jloss, argnums=(0, 1))(jp.a, jp.b)
    tp = treg.build_ns(name, nfe, None)
    a = tp.a.clone().requires_grad_(True)
    b = tp.b.clone().requires_grad_(True)
    x = tns.ns_sample(tns.NSParams(tp.times, a, b), _linear_u_np, torch.from_numpy(x0))
    (x * x).sum().backward()
    for got, want in ((a.grad, ja), (b.grad, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL["float32"] * nfe, rtol=TOL["float32"])
    assert not np.triu(b.grad.numpy(), 1).any()


def _linear_u_np(t, x, rate=1.5, drift=0.7):
    """``repro.core.toy.linear_field``: u_t(x) = -rate x + drift t."""
    return -rate * x + drift * t


@pytest.mark.parametrize("name,nfe", [("euler", 8), ("midpoint", 8), ("rk4", 8),
                                      ("ab2", 6), ("heun", 4)])
def test_ns_sample_matches_reference_on_linear_field(name, nfe):
    x0 = np.random.default_rng(nfe).standard_normal((4, 6)).astype(np.float32)
    jfield = jtoy.linear_field(jsched.fm_ot())
    jparams = jreg.build_ns(name, nfe, jfield)
    want = np.asarray(jns.ns_sample(jparams, jfield.fn, jnp.asarray(x0)))
    want_kernel = np.asarray(jns.ns_sample(jparams, jfield.fn, jnp.asarray(x0),
                                           update_fn=jax_make_update_fn(interpret=True)))
    got = tns.ns_sample(treg.build_ns(name, nfe, None), _linear_u_np, torch.from_numpy(x0))
    for ref in (want, want_kernel):
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL["float32"] * nfe,
                                   rtol=TOL["float32"])


def test_ns_sample_equals_direct_solver_run():
    """Theorem 3.2 in the port: Algorithm 1 on ``to_ns(program)`` equals the
    program run directly."""
    field = VelocityField(fn=_linear_u_np, scheduler=fm_ot())
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32))
    grid = tsolvers.grid_for_nfe("rk4", 8)
    prog = tsolvers.solver_program("rk4")
    direct = run_direct(prog, field, x0, grid)
    ns = tns.ns_sample(to_ns(prog, grid), field.fn, x0)
    np.testing.assert_allclose(ns.numpy(), direct.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("nfe", [4, 8, 16])
@pytest.mark.parametrize("name", GENERIC)
def test_registry_matches_reference(name, nfe):
    jfield = jtoy.linear_field(jsched.fm_ot())
    want = jreg.build_ns(name, nfe, jfield)
    got = treg.build_ns(name, nfe, None)
    for j, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bns_reparameterization_matches_reference():
    jp = jreg.build_ns("midpoint", 8, jtoy.linear_field(jsched.fm_ot()))
    tp = treg.build_ns("midpoint", 8, None)
    jb, tb = jns.from_ns(jp), tns.from_ns(tp)
    for j, t in zip(jb, tb):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    for j, t in zip(jns.materialize(jb), tns.materialize(tb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert tp.num_parameters() == jns.count_parameters(8)


@pytest.mark.parametrize("name", ["ddim", "dpm2m", "edm_heun"])
def test_unported_solvers_name_their_roadmap_item(name):
    """Once refused naming ROADMAP Queue A item 2, now ported: registered,
    and their NS parameters on fm_ot equal the reference's to f32 TOL
    (tests/test_torch_baselines.py holds every scheduler and NFE)."""
    assert name in treg.solver_names()
    want = jreg.build_ns(name, 8, jtoy.linear_field(jsched.fm_ot()))
    got = treg.build_ns(name, 8, VelocityField(fn=_linear_u_np, scheduler=fm_ot()))
    for j, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL["float32"],
                                   atol=TOL["float32"])


def test_sigma0_preconditioning_names_its_roadmap_item():
    """Once refused naming ROADMAP Queue A item 2, now ported: euler with
    sigma0 = 2 through the field's scheduler equals the reference's."""
    want = jreg.build_ns("euler", 8, jtoy.linear_field(jsched.fm_ot()), sigma0=2.0)
    got = treg.build_ns("euler", 8, VelocityField(fn=_linear_u_np, scheduler=fm_ot()),
                        sigma0=2.0)
    for j, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL["float32"],
                                   atol=TOL["float32"])
    assert not torch.equal(got.a, treg.build_ns("euler", 8, None).a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,shape", [(1, (4, 64)), (8, (2, 16, 8)), (5, (3, 7))])
@pytest.mark.parametrize("need_x0", [True, False])
def test_bwd_ref_matches_autograd_and_jax_grad(dtype, n, shape, need_x0):
    """ns_update_bwd_ref (the backward kernel's formulas) against torch
    autograd of ns_update_ref and jax.vjp of the reference's jnp oracle, on
    the same inputs and output gradient; f32 sums, TOL scaled by n as above
    and by the element count for the dot products (da, dw)."""
    jx, tx = _inputs(n * 10 + len(shape), n, shape, dtype)
    g = np.random.default_rng(n).standard_normal(shape).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    dx0, du, da, dw = ns_update_bwd_ref(tg, *tx, need_x0=need_x0)
    assert (dx0 is None) == (not need_x0)
    leaves = [t.clone().requires_grad_(True) for t in tx]
    want = torch.autograd.grad(ns_update_ref(*leaves), leaves, tg)
    _, vjp = jax.vjp(jax_ns_update_ref, *jx)
    jwant = vjp(jnp.asarray(g).astype(dtype))
    N = int(np.prod(shape))
    for got, w, jw, atol in ((dx0, want[0], jwant[0], TOL[dtype]),
                             (du, want[1], jwant[1], TOL[dtype] * n),
                             (da, want[2], jwant[2], TOL["float32"] * N),
                             (dw, want[3], jwant[3], TOL["float32"] * N)):
        if got is None:
            continue
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_allclose(_f32(got), _f32(w), atol=atol, rtol=TOL[dtype])
        np.testing.assert_allclose(_f32(got), _f32(jw), atol=atol, rtol=TOL[dtype])


def test_fused_update_under_grad_goes_through_the_function_with_its_plain_backward():
    """Under grad, fused_ns_update is the NSUpdate Function (whose backward is
    the kernel on the card and ns_update_bwd_ref on the CPU); without grad it
    is the plain call, with no graph."""
    from repro_torch.kernels.ns_update import ops as nu_ops

    _, (x0, u, a, w) = _inputs(4, 3, (2, 8), "float32")
    a, w = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = fused_ns_update(x0, u, a, w)
    assert type(out.grad_fn).__name__ == "NSUpdateBackward"
    calls = []
    real = nu_ops.ns_update_bwd_ref

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    nu_ops.ns_update_bwd_ref = spy
    try:
        da, dw = torch.autograd.grad(out.sum(), (a, w))
    finally:
        nu_ops.ns_update_bwd_ref = real
    assert calls == [{"need_x0": False}]
    torch.testing.assert_close(da, (x0).sum().reshape(()))
    torch.testing.assert_close(dw, u.sum(dim=(1, 2)))
    with torch.no_grad():
        assert fused_ns_update(x0, u, a, w).grad_fn is None


def test_bwd_kernel_wrapper_refuses_cpu_tensors_before_any_launch():
    _, (x0, u, a, w) = _inputs(6, 2, (2, 8), "float32")
    before = nu_mod.BWD_COUNTER.launches
    with pytest.raises(ValueError, match="CUDA"):
        nu_mod.ns_update_bwd(torch.ones_like(x0), x0, u, a, w)
    assert nu_mod.BWD_COUNTER.launches == before
