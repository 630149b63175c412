"""The port's NS update, Algorithm 1 and solver registry against the JAX
reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. On the CPU
the port's ``fused_ns_update`` runs the kernel's plain version; the reference
runs its Pallas kernel in interpret mode and its jnp oracle. Tolerances are
``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2), scaled by n for the
n-term sum as that file does.
"""
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
from repro_torch.kernels.ns_update.ref import ns_update_ref
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
    got = tns.ns_sample(treg.build_ns(name, nfe), _linear_u_np, torch.from_numpy(x0))
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
    got = treg.build_ns(name, nfe)
    for j, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bns_reparameterization_matches_reference():
    jp = jreg.build_ns("midpoint", 8, jtoy.linear_field(jsched.fm_ot()))
    tp = treg.build_ns("midpoint", 8)
    jb, tb = jns.from_ns(jp), tns.from_ns(tp)
    for j, t in zip(jb, tb):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    for j, t in zip(jns.materialize(jb), tns.materialize(tb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert tp.num_parameters() == jns.count_parameters(8)


@pytest.mark.parametrize("name", ["ddim", "dpm2m", "edm_heun"])
def test_unported_solvers_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 2"):
        treg.build_ns(name, 8)
    assert name not in treg.solver_names()


def test_sigma0_preconditioning_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 2"):
        treg.build_ns("euler", 8, sigma0=2.0)
