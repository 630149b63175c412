"""Scheduler calculus and Scale-Time transforms in the port
(``repro_torch.core.schedulers``, ``st_transform``, ``st_solvers``) against
the reference, on the CPU, and the four cases of ``tests/test_st_transform.py``
mirrored. Inputs are numpy from a seed or fixed grids; tolerance f32 2e-5
unless a case says why.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as jsched
from repro.core import solvers as jsolvers
from repro.core import st_solvers as jsts
from repro.core import st_transform as jst
from repro.core import taxonomy as jtax
from repro.core import toy as jtoy
from repro_torch.core import schedulers as tsched
from repro_torch.core import solvers as tsolvers
from repro_torch.core import st_solvers as tsts
from repro_torch.core import st_transform as tst
from repro_torch.core import taxonomy as ttax
from repro_torch.core import toy as ttoy
from repro_torch.core.rk45 import rk45_solve

TOL = 2e-5
SCHEDS = ["fm_ot", "fm_cs", "vp", "ve"]
R = np.linspace(0.02, 0.98, 13).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval(fn, r, lib):
    """fn at each r alone (scalar calls, as the solvers make them)."""
    if lib == "jax":
        return np.array([float(fn(jnp.asarray(x))) for x in r])
    return np.array([float(fn(torch.tensor(x))) for x in r])


def _mixture(lib, sched):
    if lib == "jax":
        return jtoy.mixture_field(sched, jtoy.two_moons_means(), jnp.full((16,), 0.15),
                                  jnp.ones((16,)))
    return ttoy.mixture_field(sched, ttoy.two_moons_means(), torch.full((16,), 0.15),
                              torch.ones((16,)))


@pytest.mark.parametrize("name", SCHEDS)
def test_lam_and_snr_inverse_round_trip_match_the_reference(name):
    """lam = log snr; snr_inverse(snr(t)) = t; ve's alpha_0 != 0 target included."""
    js, ts = jsched.get_scheduler(name), tsched.get_scheduler(name)
    for fn in ("snr", "lam", "alpha", "sigma", "dalpha", "dsigma"):
        np.testing.assert_allclose(_eval(getattr(ts, fn), R, "torch"),
                                   _eval(getattr(js, fn), R, "jax"), rtol=TOL, atol=TOL,
                                   err_msg=fn)
    back = _eval(lambda t: ts.snr_inverse(ts.snr(t)), R, "torch")
    np.testing.assert_allclose(back, _eval(lambda t: js.snr_inverse(js.snr(t)), R, "jax"),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(back, R, atol=1e-4)


@pytest.mark.parametrize("name", ["fm_ot", "fm_cs", "vp"])
@pytest.mark.parametrize("sigma0", [0.5, 2.0])
def test_scaled_sigma_matches_the_reference(name, sigma0):
    js = jsched.scaled_sigma(jsched.get_scheduler(name), sigma0)
    ts = tsched.scaled_sigma(tsched.get_scheduler(name), sigma0)
    assert ts.name == js.name
    for fn in ("alpha", "sigma", "snr", "lam", "dsigma"):
        np.testing.assert_allclose(_eval(getattr(ts, fn), R, "torch"),
                                   _eval(getattr(js, fn), R, "jax"), rtol=TOL, atol=TOL)
    v = _eval(ts.snr, R, "torch").astype(np.float32)
    np.testing.assert_allclose(_eval(ts.snr_inverse, v, "torch"), R, atol=1e-4)


def _st_pair(kind):
    """(reference, port) STTransform of one kind."""
    if kind == "identity":
        return jst.identity_st(), tst.identity_st()
    if kind.startswith("precondition"):
        name = kind.split(":")[1]
        return tuple(m.scheduler_change_st(s, m.scaled_sigma(s, 2.0)) for m, s in (
            (jst, jsched.get_scheduler(name)), (tst, tsched.get_scheduler(name))))
    if kind.startswith("edm"):
        name = kind.split(":")[1]
        return (jst.scheduler_change_st(jsched.get_scheduler(name), jsched.ve()),
                tst.scheduler_change_st(tsched.get_scheduler(name), tsched.ve()))
    src, tgt = kind.split("->")
    return (jst.scheduler_change_st(jsched.get_scheduler(src), jsched.get_scheduler(tgt)),
            tst.scheduler_change_st(tsched.get_scheduler(src), tsched.get_scheduler(tgt)))


ST_KINDS = ["identity", "fm_ot->fm_cs", "fm_cs->fm_ot", "vp->fm_ot", "precondition:fm_ot",
            "precondition:vp", "edm:fm_ot", "edm:fm_cs", "edm:vp"]


@pytest.mark.parametrize("kind", ST_KINDS)
def test_st_transform_t_s_dt_ds_match_the_reference(kind):
    """t, s and their jvp derivatives on an r grid, and s0, s1. EDM's VE
    target has s up to sigma_max = 80: relative tolerance. dt and ds are
    held to 2e-4: near r = 1 they differentiate through 1 - t_r, where the
    two frameworks' f32 rounding differs (preconditioned fm_ot at r = 0.98:
    ds = -0.999998 here, -0.999859 in the reference, exact -1; see
    test_preconditioned_fm_ot_has_the_closed_form)."""
    jt, tt = _st_pair(kind)
    r = np.concatenate([R, np.float32([0.0, 1.0])])
    for fn, tol in (("t", 5 * TOL), ("s", 5 * TOL), ("dt", 2e-4), ("ds", 2e-4)):
        got, want = _eval(getattr(tt, fn), r, "torch"), _eval(getattr(jt, fn), r, "jax")
        np.testing.assert_allclose(got, want, rtol=tol, atol=TOL, err_msg=fn)
    np.testing.assert_allclose([float(tt.s0), float(tt.s1)], [float(jt.s0), float(jt.s1)],
                               rtol=TOL)


def test_preconditioned_fm_ot_has_the_closed_form():
    """fm_ot -> sigma0 fm_ot: t_r = r / (sigma0 - (sigma0 - 1) r) and
    s_r = sigma0 - (sigma0 - 1) r, so dt = sigma0 / (sigma0 - (sigma0 - 1) r)^2
    and ds = 1 - sigma0; the port's jvp derivatives hold them to f32."""
    _, st = _st_pair("precondition:fm_ot")
    den = 2.0 - R.astype(np.float64)
    np.testing.assert_allclose(_eval(st.t, R, "torch"), R / den, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_eval(st.s, R, "torch"), den, rtol=1e-6)
    np.testing.assert_allclose(_eval(st.dt, R, "torch"), 2.0 / den**2, rtol=1e-5)
    np.testing.assert_allclose(_eval(st.ds, R, "torch"), -1.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["fm_ot", "vp"])
def test_transformed_field_and_its_scheduler_match_the_reference(name):
    """u_bar (eq. 7) at (r, x) from a seed, and the transformed scheduler's
    bisection snr_inverse (63 halvings)."""
    jfield = _mixture("jax", jsched.get_scheduler(name))
    tfield = _mixture("torch", tsched.get_scheduler(name))
    jbar, _ = jst.precondition(jfield, 2.5)
    tbar, _ = tst.precondition(tfield, 2.5)
    x = np.random.default_rng(0).standard_normal((8, 2)).astype(np.float32)
    for r in (0.05, 0.5, 0.9):
        np.testing.assert_allclose(
            tbar.fn(torch.tensor(r), torch.from_numpy(x)).numpy(),
            np.asarray(jbar.fn(jnp.asarray(r), jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    v = np.float32([0.1, 1.0, 7.5])
    got = tbar.scheduler.snr_inverse(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbar.scheduler.snr_inverse(jnp.asarray(v))),
                               atol=1e-5)
    np.testing.assert_allclose(tbar.scheduler.snr(torch.from_numpy(got)).numpy(), v,
                               rtol=1e-3)


@pytest.mark.parametrize("kind", ["precondition:fm_ot", "edm:vp", "fm_ot->fm_cs"])
@pytest.mark.parametrize("base", ["euler", "heun", "midpoint"])
def test_st_program_to_ns_and_direct_run_match_the_reference(kind, base):
    """A generic program lifted by st_program: NS parameters against the
    reference's, and the direct run against Algorithm 1 on them."""
    jt, tt = _st_pair(kind)
    grid = tsolvers.grid_for_nfe(base, 8)
    tprog = tsts.st_program(tsolvers.solver_program(base), tt)
    jprog = jsts.st_program(jsolvers.solver_program(base), jt)
    got, want = ttax.to_ns(tprog, grid), jtax.to_ns(jprog, grid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5 * TOL, atol=TOL)
    from repro_torch.core.ns_solver import ns_sample

    field = _mixture("torch", tsched.fm_ot())
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 2)).astype(np.float32))
    with torch.no_grad():
        direct = ttax.run_direct(tprog, field, x0, grid)
        via_ns = ns_sample(got, field.fn, x0)
    np.testing.assert_allclose(via_ns.numpy(), direct.numpy(), rtol=1e-4, atol=1e-4)


def test_edm_program_matches_the_reference_on_a_power_grid():
    grid = tsolvers.power_grid(4, rho=2.0)
    got = ttax.to_ns(tsts.edm_program(tsolvers.heun_program, tsched.fm_ot()), grid)
    want = jtax.to_ns(jsts.edm_program(jsolvers.heun_program, jsched.fm_ot()), grid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5 * TOL, atol=TOL)


# ---------------------------------------------------------------------------
# tests/test_st_transform.py, mirrored in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sname,tname", [("fm_ot", "fm_cs"), ("fm_cs", "fm_ot"),
                                          ("vp", "fm_ot")])
def test_scheduler_change_identities(sname, tname):
    """eq. 8: alpha_bar_r = s_r alpha_{t_r}, sigma_bar_r = s_r sigma_{t_r}."""
    src, tgt = tsched.get_scheduler(sname), tsched.get_scheduler(tname)
    st = tst.scheduler_change_st(src, tgt)
    for r in [0.1, 0.33, 0.5, 0.77, 0.9]:
        r_ = torch.tensor(r)
        t, s = st.t(r_), st.s(r_)
        np.testing.assert_allclose(float(s * src.alpha(t)), float(tgt.alpha(r_)), atol=2e-3)
        np.testing.assert_allclose(float(s * src.sigma(t)), float(tgt.sigma(r_)), atol=2e-3)


def test_identity_transform_is_identity():
    st = tst.identity_st()
    r = torch.tensor(0.4)
    assert float(st.t(r)) == pytest.approx(0.4)
    assert float(st.s(r)) == pytest.approx(1.0)
    assert float(st.dt(r)) == pytest.approx(1.0)
    assert float(st.ds(r)) == pytest.approx(0.0, abs=1e-6)


def test_transformed_field_recovers_samples():
    """Integrate u_bar from s_0 x0, unscale by s_1 -> same sample as u from x0."""
    field = _mixture("torch", tsched.fm_ot())
    ubar, st = tst.precondition(field, sigma0=2.5)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32))
    with torch.no_grad():
        direct = rk45_solve(field.fn, x0, rtol=1e-7, atol=1e-7).x1
        bar = rk45_solve(ubar.fn, st.s0 * x0, rtol=1e-7, atol=1e-7).x1 / st.s1
    err = (bar - direct).abs().numpy()
    assert err.max() < 0.05 and np.median(err) < 0.01


def test_precondition_source_std():
    """eq. 14: preconditioning sigma0 means the transformed source has std
    sigma0 (s_0 = sigma0 when sigma(0)=1)."""
    _, st = tst.precondition(_mixture("torch", tsched.fm_ot()), sigma0=5.0)
    assert float(st.s(torch.tensor(0.0))) == pytest.approx(5.0, rel=1e-3)
    assert float(st.s(torch.tensor(1.0))) == pytest.approx(1.0, rel=1e-2)
    assert float(st.t(torch.tensor(0.0))) == pytest.approx(0.0, abs=1e-4)
    assert float(st.t(torch.tensor(1.0))) == pytest.approx(1.0, abs=1e-4)
