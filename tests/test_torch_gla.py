"""The port's gated linear recurrence against the JAX reference, on the CPU.

``models.linear_scan`` (``gla_recurrent``, ``gla_step``, ``gla_chunked``)
against ``repro.models.linear_scan`` on the cases of
``tests/test_models_units.py``, and the kernel's CPU route (``ops.gla``, the
plain chunked form) against ``repro.kernels.gla_scan.gla_scan`` in interpret
mode on the ``test_gla_scan_sweep`` shapes. Inputs are made with numpy from a
seed and handed to both sides. Tolerances: the reference tests' own
(chunked-vs-recurrent 5e-4 / 2e-4; the sweep atol 20 TOL, rtol TOL with TOL
f32 2e-5, bf16 2e-2) and f32 TOL for one framework's form against the
other's same form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_scan.gla_scan import gla_scan as jax_gla_scan
from repro.models import linear_scan as J
from repro_torch.kernels.gla_scan import gla_scan as gs_mod
from repro_torch.kernels.gla_scan.ops import gla
from repro_torch.kernels.gla_scan.ref import gla_ref
from repro_torch.models import linear_scan as T

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, L, H, dk, dv, scale=0.5, ld_dk=None, s0=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, L, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, L, H, dv)).astype(np.float32)
    ld = (-np.abs(rng.standard_normal((B, L, H, ld_dk or dk))) * scale).astype(np.float32)
    out = [q, k, v, ld]
    if s0:
        out.append(rng.standard_normal((B, H, dk, dv)).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("L,chunk,inclusive,strong", [
    (4, 8, True, False), (17, 8, False, False), (33, 16, True, True),
    (64, 16, False, True), (96, 32, True, False), (50, 32, False, False),
    (96, 8, False, True), (23, 16, True, False),
])
def test_gla_chunked_matches_recurrent(L, chunk, inclusive, strong):
    """tests/test_models_units.py: chunked == recurrent over L, chunk, mode
    and decay strength, on the port's side, and each form against the
    reference's same form."""
    x = _inputs(L * 7 + chunk, 2, L, 2, 8, 12, scale=25.0 if strong else 0.5)
    o_rec, s_rec = T.gla_recurrent(*_t(x), inclusive=inclusive)
    o, s = T.gla_chunked(*_t(x), inclusive=inclusive, chunk=chunk)
    _close((o, s), (o_rec.numpy(), s_rec.numpy()), atol=5e-4, rtol=2e-4)
    _close((o_rec, s_rec), J.gla_recurrent(*_j(x), inclusive=inclusive),
           atol=TOL["float32"], rtol=TOL["float32"])
    # the strong-decay forms differ from each other by 5e-4 (the reference
    # test's tolerance), so each framework's chunked form is held at that
    _close((o, s), J.gla_chunked(*_j(x), inclusive=inclusive, chunk=chunk),
           atol=5e-4 if strong else TOL["float32"], rtol=2e-4 if strong else TOL["float32"])


def test_gla_scalar_decay_matches_broadcast():
    """One decay per head (ld's last dim 1) == that decay broadcast to dk."""
    q, k, v, ld1 = _inputs(5, 2, 64, 3, 16, 32, ld_dk=1)
    ld = np.broadcast_to(ld1, q.shape).copy()
    o1, s1 = T.gla_chunked(*_t([q, k, v, ld1]), chunk=16)
    o2, s2 = T.gla_chunked(*_t([q, k, v, ld]), chunk=16)
    _close((o1, s1), (o2.numpy(), s2.numpy()), atol=1e-4, rtol=0)
    o3, _ = T.gla_recurrent(*_t([q, k, v, ld]))
    _close((o1,), (o3.numpy(),), atol=1e-4, rtol=0)
    _close((o1, s1), J.gla_chunked(*_j([q, k, v, ld1]), chunk=16),
           atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("inclusive", [True, False])
def test_gla_state_carry_composes(inclusive):
    """Two halves with the state carried == the whole sequence; a given s0
    matches the reference's."""
    q, k, v, ld, s0 = _inputs(0, 1, 64, 2, 8, 8, s0=True)
    x = _t([q, k, v, ld])
    o_full, s_full = T.gla_chunked(*x, inclusive=inclusive, chunk=16)
    o1, s1 = T.gla_chunked(*(a[:, :32] for a in x), inclusive=inclusive, chunk=16)
    o2, s2 = T.gla_chunked(*(a[:, 32:] for a in x), s1, inclusive=inclusive, chunk=16)
    _close((torch.cat([o1, o2], 1), s2), (o_full.numpy(), s_full.numpy()), atol=1e-4, rtol=0)
    got = T.gla_chunked(*x, torch.from_numpy(s0), inclusive=inclusive, chunk=16)
    _close(got, J.gla_chunked(*_j([q, k, v, ld, s0]), inclusive=inclusive, chunk=16),
           atol=TOL["float32"], rtol=TOL["float32"])
    _close(got, [a.numpy() for a in T.gla_recurrent(*x, torch.from_numpy(s0),
                                                    inclusive=inclusive)],
           atol=5e-4, rtol=2e-4)


def test_gla_strong_decay_stays_finite():
    """ld x30 (tests/test_kernels.py): no exponent of the chunked form is
    positive, so the output is finite and matches the oracle."""
    x = _inputs(1, 1, 128, 2, 16, 16, scale=30.0)
    o, s = T.gla_chunked(*_t(x), inclusive=False, chunk=32)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    o_ref, _ = J.gla_recurrent(*_j(x), inclusive=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-3)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_step_matches_reference(inclusive, dtype):
    q, k, v, ld, S = _inputs(3, 2, 1, 4, 16, 24, s0=True)
    q, k, v, ld = (a[:, 0] for a in (q, k, v, ld))            # (B, H, d): one step
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    jq = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    o, s_new = T.gla_step(*tq, torch.from_numpy(ld), torch.from_numpy(S),
                          inclusive=inclusive)
    jo, js = J.gla_step(*jq, jnp.asarray(ld), jnp.asarray(S), inclusive=inclusive)
    assert o.dtype == getattr(torch, dtype) and s_new.dtype == torch.float32
    _close((o, s_new), (jo, js), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,chunk,inclusive,dk,dv", [
    (128, 32, True, 64, 64),     # mamba2-style (dk=d_state, dv=head_dim)
    (128, 32, False, 64, 64),    # rwkv6-style exclusive
    (96, 16, False, 32, 48),     # ragged head dims
    (64, 64, True, 16, 128),     # single chunk
])
def test_plain_route_matches_the_reference_kernel(L, chunk, inclusive, dk, dv, dtype):
    """The kernel's CPU route against the Pallas kernel in interpret mode on
    tests/test_kernels.py::test_gla_scan_sweep's shapes and tolerances; both
    take the same inputs in ``dtype`` (ld in f32, as the model gives it)."""
    q, k, v, ld = _inputs(L + chunk, 2, L, 3, dk, dv)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = gs_mod.COUNTER.launches
    o, s = gla(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(ld),
               inclusive=inclusive, chunk=chunk)
    assert gs_mod.COUNTER.launches == before                  # CPU: the plain route
    assert o.dtype == tdt and s.dtype == torch.float32
    jo, js = jax_gla_scan(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(ld),
                          inclusive=inclusive, chunk=chunk, interpret=True)
    tol = TOL[dtype]
    _close((o, s), (jo, js), atol=tol * 20, rtol=tol)


def test_ops_gla_on_cpu_is_the_chunked_form():
    q, k, v, ld, s0 = _t(_inputs(8, 2, 40, 2, 16, 16, s0=True))
    before = gs_mod.COUNTER.launches
    got = gla(q, k, v, ld, s0, inclusive=False, chunk=16)
    want = T.gla_chunked(q, k, v, ld, s0, inclusive=False, chunk=16)
    assert gs_mod.COUNTER.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gla_ref_is_the_recurrent_oracle():
    assert gla_ref is T.gla_recurrent


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, ld = _t(_inputs(0, 1, 8, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gs_mod.gla_scan(q, k, v, ld)
