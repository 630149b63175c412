"""Scale-Time solver family: a generic solver applied to an ST-transformed field.

Port of ``repro.core.st_solvers``. ``STAdapter`` wraps a taxonomy backend so
that any solver program (Euler, Midpoint, Heun, RK4, AB...) runs in the
*transformed* space x_bar = s_r x(t_r) while model evaluations are registered
at the *original* trajectory points x = x_bar / s — exactly the construction
of Theorem 3.2's ST ⊂ NS inclusion (eqs. 48-51). Works identically for the
numeric and symbolic backends, so ST solvers (including EDM and the
sigma0-preconditioned initializers of BNS) are directly convertible to NS
parameters. Grid times become f32 tensors before the transform sees them, as
the reference's ``jnp.asarray`` makes them.
"""
from __future__ import annotations

from repro_torch.core.schedulers import Scheduler, _as_t, ve
from repro_torch.core.st_transform import STTransform, scheduler_change_st


class STAdapter:
    """Presents transformed-space solver arithmetic over an original-space backend."""

    def __init__(self, be, st: STTransform):
        self.be = be
        self.st = st

    def initial(self):
        s0 = self.st.s(_as_t(0.0))
        return self.be.combine([(s0, self.be.initial())])

    def eval_u(self, r, xbar):
        r = _as_t(r)
        s, ds = self.st.s(r), self.st.ds(r)
        t, dt = self.st.t(r), self.st.dt(r)
        x = self.be.combine([(1.0 / s, xbar)])
        u = self.be.eval_u(t, x)
        # u_bar_r(x_bar) = (s'/s) x_bar + t' s u_{t_r}(x_bar / s)   (eq. 7)
        return self.be.combine([(ds / s, xbar), (dt * s, u)])

    def combine(self, terms):
        return self.be.combine(terms)

    def finalize(self, xbar):
        s1 = self.st.s(_as_t(1.0))
        return self.be.finalize(self.be.combine([(1.0 / s1, xbar)]))


def st_program(base_program, st: STTransform):
    """Lift a generic solver program to its Scale-Time version."""

    def prog(be, grid, *args, **kwargs):
        base_program(STAdapter(be, st), grid, *args, **kwargs)

    return prog


def edm_program(base_program, sched: Scheduler, sigma_max: float = 80.0):
    """EDM (Karras et al. 2022): scheduler change to VE + a generic solver.

    EDM's canonical choice is Heun with a rho-warped grid (see
    ``solvers.power_grid``); any base program works here.
    """
    st = scheduler_change_st(sched, ve(sigma_max))
    return st_program(base_program, st)
