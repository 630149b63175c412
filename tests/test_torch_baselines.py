"""The baseline solver families in the port (``repro_torch.core.exponential``,
``st_solvers.edm_program``, sigma0 preconditioning of the generic solvers,
the registry's capabilities, ``core.cfg``) against the reference, on the CPU.

Every name in the reference's ``solver_names()`` builds NS parameters for
fm_ot, fm_cs and vp at NFE 4, 8 and 16 (sigma0 1 and 2 for the generic
family) within f32 2e-5 of the reference's, relative to each field's
largest entry: EDM's coefficients cancel (under vp at NFE 4, a = 0.426
beside 341), so an entry near 0 carries its neighbours' rounding (6.5e-5
there, 1.9e-7 of the largest). Inputs are numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cfg as jcfg
from repro.core import exponential as jexp
from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import taxonomy as jtax
from repro.core import toy as jtoy
from repro.core.parametrization import VelocityField as JaxField
from repro.solvers import registry as jreg
from repro_torch.core import cfg as tcfg
from repro_torch.core import exponential as texp
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import taxonomy as ttax
from repro_torch.core import toy as ttoy
from repro_torch.core.parametrization import VelocityField
from repro_torch.solvers import registry as treg

TOL = 2e-5
SCHEDS = ["fm_ot", "fm_cs", "vp"]
NFES = [4, 8, 16]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(sname):
    """Scheduler-only fields (the builds read nothing else)."""
    return (JaxField(fn=None, scheduler=jsched.get_scheduler(sname)),
            VelocityField(fn=None, scheduler=tsched.get_scheduler(sname)))


def _mixtures(sname):
    return (jtoy.mixture_field(jsched.get_scheduler(sname), jtoy.two_moons_means(),
                               jnp.full((16,), 0.15), jnp.ones((16,))),
            ttoy.mixture_field(tsched.get_scheduler(sname), ttoy.two_moons_means(),
                               torch.full((16,), 0.15), torch.ones((16,))))


def _build_cases():
    cases = []
    for name in jreg.solver_names():
        info = jreg.get_solver(name)
        for sname in SCHEDS:
            for nfe in NFES:
                if not info.valid_nfe(nfe):
                    continue
                for sigma0 in ((1.0, 2.0) if info.supports_sigma0 else (1.0,)):
                    cases.append((name, sname, nfe, sigma0))
    return cases


@pytest.mark.parametrize("sname", SCHEDS)
@pytest.mark.parametrize("nfe", NFES)
def test_exp_grid_equals_the_reference(sname, nfe):
    """lambda on the reference's jnp.linspace arithmetic, the times f32,
    endpoints pinned. Not to the bit: lambda (one point, fm_ot NFE 4) and
    XLA's f32 exp are each 1 ulp off torch's, which moves t = snr^-1 by up to
    6 f32 ulps (2.4e-7 relative) at fm_ot NFE 4 and 1 ulp at fm_cs NFE 16;
    the other grids are equal to the bit."""
    jf, tf = _fields(sname)
    got, want = texp.exp_grid(tf.scheduler, nfe), jexp.exp_grid(jf.scheduler, nfe)
    assert got.dtype == want.dtype == np.float64
    assert (got[0], got[-1]) == (want[0], want[-1])
    np.testing.assert_array_equal(got[1:-1].astype(np.float32).astype(np.float64), got[1:-1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,sname,nfe,sigma0", _build_cases())
def test_build_ns_matches_the_reference(name, sname, nfe, sigma0):
    jf, tf = _fields(sname)
    want = jreg.build_ns(name, nfe, jf, sigma0=sigma0)
    got = treg.build_ns(name, nfe, tf, sigma0=sigma0)
    for g, w, what in zip(got, want, ("times", "a", "b")):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL * scale,
                                   err_msg=what)


@pytest.mark.parametrize("name", jreg.solver_names())
def test_registry_capabilities_match_the_reference(name):
    """Every SolverInfo field, default_grid for each scheduler and NFE, and
    valid_nfe for NFE 1..16."""
    want, got = jreg.get_solver(name), treg.get_solver(name)
    for key in ("name", "family", "supports_sigma0", "needs_scheduler", "grid_family",
                "evals_per_interval", "baseline"):
        assert getattr(got, key) == getattr(want, key), key
    for sname in SCHEDS:
        jf, tf = _fields(sname)
        for nfe in NFES:
            if want.valid_nfe(nfe):
                # the lambda grid: within 6 f32 ulps (test_exp_grid_equals_the_reference)
                np.testing.assert_allclose(got.default_grid(nfe, tf),
                                           want.default_grid(nfe, jf), rtol=1e-6, atol=0)
    assert [got.valid_nfe(n) for n in range(1, 17)] == [want.valid_nfe(n) for n in range(1, 17)]


def test_registry_names_and_filters_match_the_reference():
    assert treg.solver_names() == jreg.solver_names()
    for filters in (dict(baseline=True), dict(family="generic"), dict(family="exponential"),
                    dict(family="scale-time"), dict(supports_sigma0=True),
                    dict(supports_sigma0=False), dict(family="generic", baseline=True)):
        assert treg.solver_names(**filters) == jreg.solver_names(**filters), filters
    with pytest.raises(ValueError, match="sigma0"):
        treg.build_ns("edm_heun", 8, _fields("fm_ot")[1], sigma0=2.0)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("sname", SCHEDS)
def test_dpm2m_both_settings_match_the_reference(exact, sname):
    """DPM-Solver++(2M), midpoint rule and exact integration of the linear
    extrapolation: NS parameters, and the direct run on the mixture field."""
    jf, tf = _mixtures(sname)
    grid = jexp.exp_grid(jf.scheduler, 8)
    got = ttax.to_ns(texp.dpm2m_program, grid, tf.scheduler, exact=exact)
    want = jtax.to_ns(jexp.dpm2m_program, grid, jf.scheduler, exact=exact)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    x0 = np.random.default_rng(2).standard_normal((32, 2)).astype(np.float32)
    with torch.no_grad():
        direct = ttax.run_direct(texp.dpm2m_program, tf, torch.from_numpy(x0), grid,
                                 tf.scheduler, exact=exact)
    jdirect = jtax.run_direct(jexp.dpm2m_program, jf, jnp.asarray(x0), grid, jf.scheduler,
                              exact=exact)
    np.testing.assert_allclose(direct.numpy(), np.asarray(jdirect), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["ddim", "dpm2m", "edm_heun"])
@pytest.mark.parametrize("sname", SCHEDS)
def test_baseline_samples_match_the_reference(name, sname):
    """Algorithm 1 with each baseline's NS parameters on the mixture field,
    port against reference: 8 f32 steps of rounding, held to 1e-4 of the
    largest sample."""
    jf, tf = _mixtures(sname)
    x0 = np.random.default_rng(5).standard_normal((64, 2)).astype(np.float32)
    params = treg.build_ns(name, 8, tf)
    with torch.no_grad():
        got = tns.ns_sample(params, tf.fn, torch.from_numpy(x0))
    want = jns.ns_sample(jreg.build_ns(name, 8, jf), jf.fn, jnp.asarray(x0))
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 * scale)
    assert np.isfinite(got.numpy()).all()


def test_exponential_program_lookup():
    assert texp.exponential_program("ddim") is texp.ddim_program
    with pytest.raises(KeyError):
        texp.exponential_program("nope")


# ---------------------------------------------------------------------------
# Classifier-free guidance (core/cfg.py)
# ---------------------------------------------------------------------------


def _linear_models(lib):
    """cond / uncond / stacked model functions on numpy-seeded weights."""
    rng = np.random.default_rng(9)
    w_c, w_u = (rng.standard_normal((3, 3)).astype(np.float32) for _ in range(2))
    as_arr = jnp.asarray if lib == "jax" else torch.from_numpy

    def cond(t, x):
        return x @ as_arr(w_c) + t

    def uncond(t, x):
        return x @ as_arr(w_u) - 0.5 * t

    def stacked(t, x, c):
        return x @ as_arr(w_c) * c[:, None] + x @ as_arr(w_u) * (1 - c[:, None]) + t * c[:, None]

    return cond, uncond, stacked


@pytest.mark.parametrize("w", [0.0, 1.5, 4.0])
def test_guided_fields_match_the_reference(w):
    x = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    jc, ju, js = _linear_models("jax")
    tc, tu, ts = _linear_models("torch")
    t = 0.3
    want = jcfg.guided_field(jc, ju, w, jsched.fm_ot()).fn(jnp.asarray(t), jnp.asarray(x))
    got = tcfg.guided_field(tc, tu, w, tsched.fm_ot()).fn(torch.tensor(t), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    cond, null = np.ones(4, np.float32), np.zeros(4, np.float32)
    want = jcfg.guided_field_stacked(js, jnp.asarray(cond), jnp.asarray(null), w,
                                     jsched.fm_ot()).fn(jnp.asarray(t), jnp.asarray(x))
    field = tcfg.guided_field_stacked(ts, torch.from_numpy(cond), torch.from_numpy(null), w,
                                      tsched.fm_ot())
    got = field.fn(torch.tensor(t), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert field.scheduler.name == "fm_ot" and got.shape == x.shape
