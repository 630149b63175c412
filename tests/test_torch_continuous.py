"""The port's continuous gateway against the JAX reference, on the CPU.

Every case of ``tests/test_continuous.py`` is mirrored on the port's
counting toy sampler and on a 2-layer backbone (yi-6b's smoke config, f32,
the reference's params through ``params_from_jax``), except the sharded case
(``mesh=``: ``tests/test_torch_placement.py``). In-port samples equal the direct
sampler's to the bit, as in the reference (whose backbone case compares at
1e-5; the port's holds exactly). Parity cases send the same
``Request(x0=...)`` traffic through the reference's ``ContinuousGateway``
and the port's: latents within f32 2e-5 (scaled by NFE on the backbone) and
equal serving metadata (served budgets, slots, join steps, batch widths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.core.anytime import init_anytime as jax_init_anytime
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticTokens as JaxSyntheticTokens
from repro.models import model as jmodel
from repro.serving import AnytimeFlowSampler as JaxAnytimeSampler
from repro.serving import ContinuousGateway as JaxContinuousGateway
from repro.serving import Request as JaxRequest
from repro.serving.toy import CountingToySampler as JaxCountingToy
from repro.serving.toy import FakeClock as JaxFakeClock
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.core.anytime import anytime_params_from_numpy, init_anytime
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import AnytimeFlowSampler, ContinuousGateway, Request
from repro_torch.serving.continuous import ContinuousScheduler
from repro_torch.serving.gateway import _Entry
from repro_torch.serving.toy import CountingToySampler, FakeClock
from repro_torch.solvers import SolverArtifact, SolverSpec

BUDGETS = (2, 4, 8)
TOL = 2e-5


class CountingCarrySampler(CountingToySampler):
    """The counting toy sampler at this suite's (2, 4, 8) budgets."""

    def __init__(self, budgets=BUDGETS, seed=0, jitter=0.1, theta=None):
        super().__init__(budgets=budgets, seed=seed, jitter=jitter, theta=theta)


def _gateway(sampler=None, **kw):
    clock = FakeClock()
    sampler = sampler or CountingCarrySampler()
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 10.0)
    gw = ContinuousGateway(sampler, clock=clock, **kw)
    return gw, sampler, clock


def _x0(i, shape=(2,)):
    return np.random.default_rng(100 + i).standard_normal(shape).astype(np.float32)


def _direct(x0s, budget):
    """Reference samples from a FRESH sampler (same theta, same arithmetic)."""
    return CountingCarrySampler().sample_from(None, np.stack(x0s), budget)


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _entry(uid, served, t=0.0):
    return _Entry(uid=uid, tokens=None, x0=np.zeros((2,), np.float32), requested=served,
                  served=served, shape_key=(None, (2,)), t_submit=t, future=None)


# ---------------------------------------------------------------------------
# ContinuousScheduler (pure planning)
# ---------------------------------------------------------------------------


def test_plan_start_waits_until_full_or_aged():
    s = ContinuousScheduler(max_slots=2, boundaries=BUDGETS, max_wait_ms=10.0)
    young = [_entry(0, 4)]
    assert s.plan_start(young, now=0.005) == []
    assert [e.uid for e in s.plan_start(young, now=0.011)] == [0]
    assert [e.uid for e in s.plan_start(young, now=0.0, force=True)] == [0]
    full = [_entry(i, 4) for i in range(3)]
    assert [e.uid for e in s.plan_start(full, now=0.0)] == [0, 1]


def test_plan_joins_filters_budget_shape_and_slots():
    s = ContinuousScheduler(max_slots=4, boundaries=BUDGETS)
    pending = [_entry(0, 2), _entry(1, 8), _entry(2, 4), _entry(3, 8)]
    got = s.plan_joins(pending, boundary=4, free_slots=4, shape_key=(None, (2,)))
    assert [e.uid for e in got] == [1, 3]
    got = s.plan_joins(pending, boundary=2, free_slots=2, shape_key=(None, (2,)))
    assert [e.uid for e in got] == [1, 2]
    assert s.plan_joins(pending, 2, 4, shape_key=(None, (3,))) == []
    assert s.plan_joins(pending, 2, 0, shape_key=(None, (2,))) == []


def test_join_bucket_and_next_boundary():
    s = ContinuousScheduler(max_slots=8, boundaries=BUDGETS)
    assert [s.join_bucket(k) for k in (1, 2, 3, 8)] == [1, 2, 4, 8]
    with pytest.raises(ValueError):
        s.join_bucket(9)
    assert s.next_boundary(0) == 2
    assert s.next_boundary(2) == 4
    assert s.next_boundary(7) == 8
    assert s.next_boundary(8) is None
    with pytest.raises(ValueError):
        ContinuousScheduler(max_slots=0, boundaries=BUDGETS)


def test_join_cost_cap_blocks_expensive_joins():
    pending = [_entry(0, 8)]
    shape = (None, (2,))
    s = ContinuousScheduler(max_slots=4, boundaries=BUDGETS, join_cost_cap=0.5)
    assert [e.uid for e in s.plan_joins(pending, 4, 4, shape)] == [0]
    tight = ContinuousScheduler(max_slots=4, boundaries=BUDGETS, join_cost_cap=0.25)
    assert tight.plan_joins(pending, 4, 4, shape) == []
    assert [e.uid for e in tight.plan_joins(pending, 2, 4, shape)] == [0]
    with pytest.raises(ValueError):
        ContinuousScheduler(max_slots=4, boundaries=BUDGETS, join_cost_cap=0.0)
    with pytest.raises(ValueError):
        ContinuousScheduler(max_slots=4, boundaries=BUDGETS, max_leg=0)


def test_plan_start_shape_groups_independent():
    s = ContinuousScheduler(max_slots=2, boundaries=BUDGETS, max_wait_ms=10.0)

    def e(uid, shape, t=0.0):
        return _Entry(uid=uid, tokens=None, x0=np.zeros(shape, np.float32), requested=4,
                      served=4, shape_key=(None, shape), t_submit=t, future=None)

    lone_a = e(0, (3,))
    full_b = [e(1, (2,)), e(2, (2,))]
    assert [x.uid for x in s.plan_start([lone_a, *full_b], now=0.005)] == [1, 2]
    aged_b = e(3, (2,), t=-0.02)
    assert [x.uid for x in s.plan_start([lone_a, aged_b], now=0.005)] == [3]
    full_a = [e(5, (3,)), e(6, (3,))]
    assert [x.uid for x in s.plan_start([*full_b, *full_a], now=0.0)] == [1, 2]
    assert [x.uid for x in s.plan_start([lone_a, e(9, (2,))], now=0.0,
                                        force=True)] == [0]
    assert s.plan_start([lone_a], now=0.005) == []


# ---------------------------------------------------------------------------
# Trajectory lifecycle (fake clock, manual pump)
# ---------------------------------------------------------------------------


def test_trajectory_releases_each_budget_at_its_boundary():
    gw, sampler, clock = _gateway()
    futs = {b: gw.submit(Request(budget=b, x0=_x0(b))) for b in (2, 4)}
    clock.advance(1.0)
    assert gw.pump() == 1
    assert sampler.forwards == 0
    assert gw.pump() == 1
    assert futs[2].done() and not futs[4].done()
    assert sampler.forwards == 2
    assert gw.pump() == 1
    assert futs[4].done()
    assert sampler.forwards == 4
    assert gw._traj is None
    s = gw.stats()
    assert s["trajectories"] == 1 and s["legs"] == 2 and s["joins"] == 0


def test_continuous_samples_bit_identical_to_direct_sampler():
    gw, sampler, clock = _gateway()
    x0s = [_x0(i) for i in range(3)]
    futs = [gw.submit(Request(budget=b, x0=x)) for b, x in zip((2, 4, 8), x0s)]
    gw.drain()
    for fut, b, x0 in zip(futs, (2, 4, 8), x0s):
        res = fut.result(timeout=5)
        assert isinstance(res.latents, np.ndarray)
        _bits(res.latents, _direct([x0], b)[0])
        assert res.meta["continuous"] and res.meta["served_budget"] == b
        assert res.meta["join_step"] == 0


def test_join_mid_flight_costs_at_most_budget_incremental_forwards():
    gw, sampler, clock = _gateway()
    starters = [gw.submit(Request(budget=8, x0=_x0(i))) for i in range(2)]
    clock.advance(1.0)
    assert gw.pump() == 1
    assert gw.pump() == 1
    x_late = _x0(9)
    late = gw.submit(Request(budget=8, x0=x_late))
    before = sampler.forwards
    assert gw.pump() == 1                       # leg 2..4, then the join
    assert sampler.forwards - before == 2 + 4
    assert gw.pump() == 1                       # leg 4..8: everyone exits
    for f in starters + [late]:
        assert f.done()
    assert sampler.forwards - 8 == 4
    _bits(late.result(timeout=5).latents, _direct([x_late], 8)[0])
    meta = late.result(timeout=5).meta
    assert meta["join_step"] == 4 and meta["continuous"]
    s = gw.stats()
    assert s["joins"] == 1 and s["join_rate"] == pytest.approx(1 / 3)


def test_released_slot_is_rejoined_and_trajectory_extends():
    gw, sampler, clock = _gateway(max_slots=2)
    f2 = gw.submit(Request(budget=2, x0=_x0(0)))
    f4 = gw.submit(Request(budget=4, x0=_x0(1)))
    assert gw.pump() == 1
    assert gw.pump() == 1
    assert f2.done()
    x_late = _x0(2)
    f8 = gw.submit(Request(budget=8, x0=x_late))
    assert gw.pump() == 1
    assert f4.done() and not f8.done()
    assert gw._traj is not None
    assert gw.pump() == 1
    assert f8.done()
    _bits(f8.result(timeout=5).latents, _direct([x_late], 8)[0])
    assert sampler.forwards == 8 + 4


def test_non_joinable_aged_request_flushes_between_legs():
    gw, sampler, clock = _gateway(max_slots=2)
    big = [gw.submit(Request(budget=8, x0=_x0(i))) for i in range(2)]
    assert gw.pump() == 1
    f2 = gw.submit(Request(budget=2, x0=_x0(7)))
    assert gw.pump() == 1
    assert not f2.done()
    clock.advance(0.011)
    assert gw.pump() == 2
    assert f2.done() and gw._traj is not None
    assert "continuous" not in f2.result(timeout=5).meta
    gw.drain()
    assert all(f.done() for f in big)


def test_full_flush_bucket_dispatches_immediately_mid_flight():
    gw, sampler, clock = _gateway(max_slots=2, max_batch=2)
    big = [gw.submit(Request(budget=8, x0=_x0(i))) for i in range(2)]
    assert gw.pump() == 1
    small = [gw.submit(Request(budget=2, x0=_x0(10 + i))) for i in range(2)]
    assert gw.pump() == 2
    assert all(f.done() for f in small)
    gw.drain()
    assert all(f.done() for f in big)


def test_drain_completes_trajectory_and_queue():
    gw, sampler, clock = _gateway()
    futs = [gw.submit(Request(budget=b, x0=_x0(i)))
            for i, b in enumerate((8, 8, 4, 2, 2))]
    gw.drain()
    assert all(f.done() for f in futs)
    assert gw._traj is None and gw.queue.depth() == 0
    with pytest.raises(RuntimeError):
        gw.submit(Request(budget=2, x0=_x0(9)))


def test_slot_occupancy_accounting():
    gw, sampler, clock = _gateway(max_slots=4)
    gw.submit(Request(budget=2, x0=_x0(0)))
    gw.submit(Request(budget=4, x0=_x0(1)))
    gw.drain()
    s = gw.stats()
    assert s["slot_occupancy"] == pytest.approx((2 * 2 + 1 * 2) / (4 * 4))
    assert s["legs"] == 2 and s["forwards"] == 4


def test_max_leg_clips_control_points_not_exits():
    gw, sampler, clock = _gateway(max_slots=2, max_leg=1)
    x0s = [_x0(0), _x0(1)]
    futs = [gw.submit(Request(budget=b, x0=x)) for b, x in zip((4, 8), x0s)]
    assert gw.pump() == 1
    for _ in range(8):
        gw.pump()
    assert all(f.done() for f in futs)
    assert sampler.forwards == 8
    assert gw.stats()["legs"] == 8
    for f, b, x0 in zip(futs, (4, 8), x0s):
        _bits(f.result(timeout=5).latents, _direct([x0], b)[0])


def test_trajectory_restart_outranks_mixed_flush():
    gw, sampler, clock = _gateway(max_slots=2)
    first = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(2)]
    assert gw.pump() == 1
    nxt = [gw.submit(Request(budget=2, x0=_x0(5 + i))) for i in range(2)]
    clock.advance(1.0)
    assert gw.pump() == 2
    assert all(f.done() for f in first)
    assert gw._traj is not None
    assert gw.stats()["trajectories"] == 2
    gw.drain()
    assert all(f.done() for f in nxt)
    for f in nxt:
        assert f.result(timeout=5).meta["continuous"]
    assert gw.stats()["batches"] == 0


def test_failed_leg_surfaces_into_slot_futures_and_engine_survives():
    class ExplodingLeg(CountingCarrySampler):
        def carry_extend(self, batch, carry, stop):
            raise RuntimeError("device boom")

    gw, _, clock = _gateway(ExplodingLeg(), max_slots=2)
    futs = [gw.submit(Request(budget=4, x0=_x0(i))) for i in range(2)]
    assert gw.pump() == 1
    assert gw.pump() == 1
    for f in futs:
        with pytest.raises(RuntimeError, match="device boom"):
            f.result(timeout=0)
    assert gw._traj is None and gw.stats()["failed"] == 2
    gw.submit(Request(budget=4, x0=_x0(9)))
    gw.drain()


def test_failed_start_fails_starters_not_engine():
    class ExplodingStart(CountingCarrySampler):
        def carry_start(self, batch, x0):
            raise RuntimeError("init boom")

    gw, _, clock = _gateway(ExplodingStart(), max_slots=2)
    futs = [gw.submit(Request(budget=4, x0=_x0(i))) for i in range(2)]
    assert gw.pump() == 1
    for f in futs:
        with pytest.raises(RuntimeError, match="init boom"):
            f.result(timeout=0)
    assert gw._traj is None and gw.queue.depth() == 0


def test_failed_join_prefix_fails_joiners_but_trajectory_rolls_on():
    class ExplodingPrefix(CountingCarrySampler):
        def carry_extend(self, batch, carry, stop):
            if carry.step == 0 and self.forwards > 0:
                raise RuntimeError("prefix boom")
            return super().carry_extend(batch, carry, stop)

    gw, sampler, clock = _gateway(ExplodingPrefix(), max_slots=2)
    keeper = gw.submit(Request(budget=8, x0=_x0(0)))
    clock.advance(1.0)
    assert gw.pump() == 1
    assert gw.pump() == 1
    doomed = gw.submit(Request(budget=8, x0=_x0(1)))
    assert gw.pump() >= 1
    with pytest.raises(RuntimeError, match="prefix boom"):
        doomed.result(timeout=30)
    gw.drain()
    assert keeper.result(timeout=30).meta["served_budget"] == 8
    _bits(keeper.result(timeout=30).latents, _direct([_x0(0)], 8)[0])


def test_requires_carry_protocol():
    class NoCarry:
        budgets = (2, 4)

        def resolve_budget(self, m, strict=False):
            return m

    with pytest.raises(TypeError, match="carry"):
        ContinuousGateway(NoCarry())


def test_threaded_serve_forever_with_continuous_batching():
    sampler = CountingCarrySampler()
    gw = ContinuousGateway(sampler, max_slots=2, max_wait_ms=2.0)
    gw.start()
    futs = [gw.submit(Request(budget=b, x0=_x0(i))) for i, b in enumerate((2, 4, 8))]
    for f in futs:
        assert f.result(timeout=30).latents.shape == (2,)
    gw.shutdown(timeout=30)
    assert gw.stats()["completed"] == 3


def test_join_leaves_earlier_exits_and_carry_untouched():
    """A join writes into clones of the carry's tensors: the carry an
    earlier leg returned, and the rows it exited, keep their values."""
    gw, sampler, clock = _gateway(max_slots=2)
    first = gw.submit(Request(budget=2, x0=_x0(0)))
    gw.submit(Request(budget=8, x0=_x0(1)))
    assert gw.pump() == 1
    assert gw.pump() == 1                       # leg 0..2 releases budget 2
    before = gw._traj.carry
    kept = [t.clone() for t in (before.x0, before.U, before.x)]
    row = first.result(timeout=5).latents.copy()
    gw.submit(Request(budget=8, x0=_x0(2)))
    assert gw.pump() == 1                       # leg 2..4 + a join at 4
    assert gw.stats()["joins"] == 1
    for t, k in zip((before.x0, before.U, before.x), kept):
        assert torch.equal(t, k)
    _bits(first.result(timeout=5).latents, row)


# ---------------------------------------------------------------------------
# The 2-layer backbone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tok = np.array(JaxSyntheticTokens(jcfg, JaxDataConfig(batch_size=4, seq_len=8))
                   .batch(0)["tokens"])
    budgets = (2, 4)
    art = SolverArtifact(spec=SolverSpec("midpoint", mode="anytime", budgets=budgets),
                         params=init_anytime(None, budgets, "nested"), val_psnr=0.0)

    def make_sampler():
        return AnytimeFlowSampler.from_artifact(art, params=params, cfg=cfg,
                                                sched=tsched.fm_ot())

    def make_reference():
        from repro.solvers import SolverArtifact as JaxArtifact
        from repro.solvers import SolverSpec as JaxSpec

        jart = JaxArtifact(spec=JaxSpec("midpoint", mode="anytime", budgets=budgets),
                           params=jax_init_anytime(None, budgets, "nested"), val_psnr=0.0)
        return JaxAnytimeSampler.from_artifact(jart, params=jparams, cfg=jcfg,
                                               sched=jsched.fm_ot())

    return cfg, tok, make_sampler, make_reference


def _bx0(seed, rows, cfg):
    return np.random.default_rng(seed).standard_normal(
        (rows, 8, cfg.latent_dim)).astype(np.float32)


def test_backbone_carry_extend_matches_sample_all(backbone):
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    cond = {"tokens": torch.from_numpy(tok[:2])}
    x0 = _bx0(3, 2, cfg)
    ref = sampler.sample_all_from(cond, x0)
    carry = sampler.carry_start(cond, x0)
    carry, exits2 = sampler.carry_extend(cond, carry, 2)
    carry, exits4 = sampler.carry_extend(cond, carry, 4)
    assert carry.step == 4
    assert torch.equal(exits2[2], ref[2]) and torch.equal(exits4[4], ref[4])


def test_backbone_continuous_gateway_end_to_end(backbone):
    """Starters and a later request on the real backbone all equal the
    direct per-budget sampler on their row alone, to the bit."""
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    clock = FakeClock()
    gw = ContinuousGateway(sampler, max_slots=2, max_wait_ms=10.0, clock=clock)
    x0 = _bx0(5, 3, cfg)
    f2 = gw.submit(Request(tokens=tok[0], budget=2, x0=x0[0]))
    f4 = gw.submit(Request(tokens=tok[1], budget=4, x0=x0[1]))
    assert gw.pump() == 1
    assert gw.pump() == 1
    late = gw.submit(Request(tokens=tok[2], budget=4, x0=x0[2]))
    assert gw.pump() == 1
    gw.drain()
    for fut, row, b in ((f2, 0, 2), (f4, 1, 4), (late, 2, 4)):
        direct = sampler.sample_from({"tokens": torch.from_numpy(tok[row:row + 1])},
                                     x0[row:row + 1], b)
        _bits(fut.result(timeout=5).latents, direct[0])


def test_backbone_join_mid_flight_bit_identical(backbone):
    """A request joining at boundary 2 (budgets 2 and 4, budget 4 > 2)
    equals its row sampled alone, and its batch-mates stay exact."""
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    gw = ContinuousGateway(sampler, max_slots=2, max_wait_ms=10.0, clock=FakeClock())
    x0 = _bx0(8, 3, cfg)
    f_a = gw.submit(Request(tokens=tok[0], budget=2, x0=x0[0]))
    f_b = gw.submit(Request(tokens=tok[1], budget=4, x0=x0[1]))
    assert gw.pump() == 1                       # opens (slots full)
    joiner = gw.submit(Request(tokens=tok[2], budget=4, x0=x0[2]))
    assert gw.pump() == 1                       # leg 0..2 releases a, joins
    assert gw.stats()["joins"] == 1
    gw.drain()
    assert joiner.result(timeout=5).meta["join_step"] == 2
    for fut, row, b in ((f_a, 0, 2), (f_b, 1, 4), (joiner, 2, 4)):
        direct = sampler.sample_from({"tokens": torch.from_numpy(tok[row:row + 1])},
                                     x0[row:row + 1], b)
        _bits(fut.result(timeout=5).latents, direct[0])


# ---------------------------------------------------------------------------
# Parity with the reference's ContinuousGateway
# ---------------------------------------------------------------------------

META = ("requested_budget", "served_budget", "nfe_batch", "batch_real", "batch_padded",
        "mixed", "continuous", "join_step", "slot")


def _drive_both(ref_sampler, port_sampler, script, **kw):
    """Run ``script(gw, Request, tok_fn, clock)`` on both gateways, then
    drain; returns each side's results and stats."""
    out = []
    for gw_cls, req_cls, clock, sampler, tok_fn in (
            (JaxContinuousGateway, JaxRequest, JaxFakeClock(), ref_sampler, jnp.asarray),
            (ContinuousGateway, Request, FakeClock(), port_sampler, torch.from_numpy)):
        gw = gw_cls(sampler, clock=clock, **kw)
        futs = script(gw, req_cls, tok_fn, clock)
        gw.drain()
        out.append(([f.result(timeout=30) for f in futs], gw.stats()))
    return out


def _joins_script(x0s, budgets, toks=None):
    def script(gw, req, tok_fn, clock):
        def sub(i):
            t = None if toks is None else tok_fn(toks[i])
            return gw.submit(req(budget=budgets[i], x0=x0s[i], tokens=t))
        futs = [sub(0), sub(1)]
        clock.advance(1.0)
        gw.pump()                               # opens
        gw.pump()                               # first leg
        futs += [sub(i) for i in range(2, len(x0s))]
        gw.pump()
        return futs
    return script


def _check(both, tol):
    (jres, jstats), (tres, tstats) = both
    for j, t in zip(jres, tres):
        assert {k: t.meta.get(k) for k in META} == {k: j.meta.get(k) for k in META}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents), atol=tol, rtol=tol)
    for key in ("trajectories", "legs", "joins", "forwards", "completed", "batches",
                "slot_occupancy"):
        assert tstats[key] == jstats[key], key


@pytest.mark.parametrize("budgets", [(8, 8, 8, 4), (2, 4, 8, 8), (2, 8, 4, 2)])
def test_toy_traffic_matches_the_reference_continuous_gateway(budgets):
    ref = JaxCountingToy(budgets=BUDGETS)
    theta = anytime_params_from_numpy(*(np.asarray(p) for p in ref.theta))
    port = CountingCarrySampler(theta=theta)
    x0s = [_x0(i) for i in range(len(budgets))]
    _check(_drive_both(ref, port, _joins_script(x0s, budgets), max_slots=2,
                       max_wait_ms=10.0), TOL)
    assert port.forwards == ref.forwards


def test_backbone_traffic_matches_the_reference_continuous_gateway(backbone):
    cfg, tok, make_sampler, make_reference = backbone
    x0s = list(_bx0(11, 4, cfg))
    _check(_drive_both(make_reference(), make_sampler(),
                       _joins_script(x0s, (2, 4, 4, 2), toks=tok), max_slots=2,
                       max_wait_ms=10.0), TOL * 4)
