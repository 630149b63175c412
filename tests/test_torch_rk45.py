"""The port's adaptive RK45 against ``repro.core.rk45``, on the CPU.

The reference's three checks (``tests/test_rk45.py``) on the port, and the
port's x1, nfe, accepted and rejected against the reference's on the same
numpy inputs, on the linear and mixture toy fields. Both carry the step's
time and size in f32 and take the same accept decisions, so the counts must
be equal down to rtol = atol = 1e-6 (at 1e-8 the estimate is f32 rounding
noise: see that case); x1 agrees to ``tests/test_kernels.py``'s f32 2e-5 where the
integration is well conditioned (the linear field) and 1e-4 on the mixture
field, whose flow amplifies roundoff near basin boundaries (the reference's
own test says so).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rk45 as jrk
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro_torch.core import rk45 as trk
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run thousands of tiny eager ops (RK45 steps, training
    iterations); beside other test workers, torch's intra-op threads only
    contend for the cores, so each test runs on one and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixtures():
    j = jtoy.mixture_field(jsched.fm_ot(), jtoy.two_moons_means(),
                           jnp.full((16,), 0.15), jnp.ones((16,)))
    t = ttoy.mixture_field(tsched.fm_ot(), ttoy.two_moons_means(),
                           torch.full((16,), 0.15), torch.ones((16,)))
    return j, t


def _x0(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_exact_on_linear_field():
    field = ttoy.linear_field(tsched.fm_ot())
    x0 = torch.from_numpy(_x0(0, (5, 3)))
    res = trk.rk45_solve(field.fn, x0, rtol=1e-8, atol=1e-8)
    exact = ttoy.linear_field_solution(x0, 1.0)
    # fp32 end-to-end: tolerance reflects accumulation roundoff, not method error
    np.testing.assert_allclose(res.x1.numpy(), exact.numpy(), atol=5e-4)
    assert res.accepted > 0


def test_tolerance_controls_error():
    _, field = _mixtures()
    x0 = torch.from_numpy(_x0(0, (8, 2)))
    fine = trk.rk45_solve(field.fn, x0, rtol=1e-8, atol=1e-8).x1
    coarse = trk.rk45_solve(field.fn, x0, rtol=1e-3, atol=1e-3)
    # multimodal flows amplify integration error near basin boundaries;
    # the bound reflects ODE conditioning, not solver accuracy.
    assert float((coarse.x1 - fine).abs().max()) < 0.15
    assert coarse.nfe < 10_000


def test_nfe_counts_evals():
    field = ttoy.linear_field(tsched.fm_ot())
    calls = []

    def counted(t, x):
        calls.append(float(t))
        return field.fn(t, x)

    res = trk.rk45_solve(counted, torch.ones((2, 2)), rtol=1e-5, atol=1e-5)
    assert isinstance(res.nfe, int) and isinstance(res.accepted, int)
    assert res.nfe == 7 * (res.accepted + res.rejected) == len(calls)


@pytest.mark.parametrize("tol", [1e-3, 1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(5, 3), (2, 4, 6)])
def test_linear_field_matches_reference(tol, shape):
    jf = jtoy.linear_field(jsched.fm_ot())
    tf = ttoy.linear_field(tsched.fm_ot())
    x0 = _x0(len(shape) + int(-np.log10(tol)), shape)
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=tol, atol=tol)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=tol, atol=tol)
    assert (got.nfe, got.accepted, got.rejected) == (
        int(want.nfe), int(want.accepted), int(want.rejected))
    np.testing.assert_allclose(got.x1.numpy(), np.asarray(want.x1), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(5, 3), (2, 4, 6)])
def test_below_f32_resolution_counts_agree_to_two_percent(shape):
    """At rtol = atol = 1e-8 the error estimate of an f32 state is rounding
    noise (the state's own ulp is ~6e-8 |x|), and the two frameworks round
    their sums differently, so single accept decisions differ: the counts
    agree to 2% (the last bit of each decision is noise), and both land on
    the exact solution as the reference's own test asks (5e-4)."""
    jf = jtoy.linear_field(jsched.fm_ot())
    tf = ttoy.linear_field(tsched.fm_ot())
    x0 = _x0(len(shape) + 8, shape)
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=1e-8, atol=1e-8)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=1e-8, atol=1e-8)
    for a, b in ((got.nfe, int(want.nfe)), (got.accepted, int(want.accepted))):
        assert abs(a - b) <= 0.02 * b
    exact = ttoy.linear_field_solution(torch.from_numpy(x0), 1.0).numpy()
    np.testing.assert_allclose(got.x1.numpy(), exact, atol=5e-4)
    np.testing.assert_allclose(np.asarray(want.x1), exact, atol=5e-4)


@pytest.mark.parametrize("tol,h0", [(1e-3, 0.01), (1e-5, 0.01), (1e-5, 0.3)])
def test_mixture_field_matches_reference(tol, h0):
    jf, tf = _mixtures()
    x0 = _x0(7, (16, 2))
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=tol, atol=tol, h0=h0)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=tol, atol=tol, h0=h0)
    assert (got.nfe, got.accepted, got.rejected) == (
        int(want.nfe), int(want.accepted), int(want.rejected))
    np.testing.assert_allclose(got.x1.numpy(), np.asarray(want.x1), rtol=1e-4, atol=1e-4)


def test_max_steps_stops_the_loop():
    _, tf = _mixtures()
    res = trk.rk45_solve(tf.fn, torch.from_numpy(_x0(1, (4, 2))), rtol=1e-9, atol=1e-9,
                         max_steps=3)
    assert res.nfe == 21 and res.accepted + res.rejected == 3
