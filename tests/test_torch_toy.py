"""The port's analytic toy fields against ``repro.core.toy``, on the CPU.

The same numpy inputs go to both sides; f32 throughout, tolerance
``tests/test_kernels.py``'s f32 2e-5 (rtol and atol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy

TOL = 2e-5
SCHEDS = ["fm_ot", "fm_cs", "vp"]


def _pair(sched_name, K=16, d=2, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((K, d)).astype(np.float32)
    stds = (0.1 + rng.random(K)).astype(np.float32)
    weights = (0.5 + rng.random(K)).astype(np.float32)
    jf = jtoy.mixture_field(jsched.get_scheduler(sched_name), jnp.asarray(means),
                            jnp.asarray(stds), jnp.asarray(weights))
    tf = ttoy.mixture_field(tsched.get_scheduler(sched_name), torch.from_numpy(means),
                            torch.from_numpy(stds), torch.from_numpy(weights))
    return jf, tf


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("t", [0.0, 0.13, 0.5, 0.91, 0.999])
def test_mixture_field_matches_reference(sched, t):
    jf, tf = _pair(sched)
    x = np.random.default_rng(1).standard_normal((5, 7, 2)).astype(np.float32)
    got = tf.fn(torch.tensor(t), torch.from_numpy(x))
    want = jf.fn(jnp.asarray(t, jnp.float32), jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_mixture_field_takes_a_python_time_and_higher_dims():
    jf, tf = _pair("fm_ot", K=4, d=6, seed=3)
    x = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_allclose(tf.fn(0.4, torch.from_numpy(x)).numpy(),
                               np.asarray(jf.fn(0.4, jnp.asarray(x))), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,radius", [(8, 1.0), (5, 0.5)])
def test_two_moons_means_match_reference(k, radius):
    got = ttoy.two_moons_means(k, radius)
    assert got.shape == (2 * k, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jtoy.two_moons_means(k, radius)),
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_linear_field_and_solution_match_reference(t):
    x = np.random.default_rng(4).standard_normal((4, 3)).astype(np.float32)
    jf = jtoy.linear_field(jsched.fm_ot(), rate=1.2, drift=0.4)
    tf = ttoy.linear_field(tsched.fm_ot(), rate=1.2, drift=0.4)
    np.testing.assert_allclose(tf.fn(torch.tensor(t), torch.from_numpy(x)).numpy(),
                               np.asarray(jf.fn(jnp.asarray(t), jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        ttoy.linear_field_solution(torch.from_numpy(x), t, 1.2, 0.4).numpy(),
        np.asarray(jtoy.linear_field_solution(jnp.asarray(x), t, 1.2, 0.4)),
        rtol=TOL, atol=TOL)


def test_linear_solution_solves_the_ode():
    """d/dt x(t) = -r x + d t, checked by a central difference in f64."""
    x0 = torch.randn(3, dtype=torch.float64)
    h, t = 1e-5, 0.37
    x = lambda s: ttoy.linear_field_solution(x0, s).double()  # noqa: E731
    dx = (x(t + h) - x(t - h)) / (2 * h)
    np.testing.assert_allclose(dx.numpy(), (-1.5 * x(t) + 0.7 * t).numpy(), atol=2e-3)
