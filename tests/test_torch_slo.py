"""The port's SLO scheduling and streaming against the JAX reference, on the
CPU, on the fake clock.

Mirrors every case of ``tests/test_slo.py``: urgency ordering, deadline-pressure flushes, admission
control against the observed cost model, queue shedding, goodput
accounting, exit-boundary preemption with bit-identical resume, flow and
decode streaming with bit-identical terminal results, and the urgent-aware
steal hooks. Parity cases drive the reference's gateways and the port's
through the same script: equal metadata and counters, latents within f32
2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import ContinuousGateway as JaxContinuousGateway
from repro.serving import Request as JaxRequest
from repro.serving import SLOConfig as JaxSLOConfig
from repro.serving.toy import CountingToySampler as JaxCountingToy
from repro.serving.toy import FakeClock as JaxFakeClock
from repro_torch.core.anytime import anytime_params_from_numpy
from repro_torch.serving import (
    AdmissionRejected,
    ContinuousGateway,
    DeadlineExceeded,
    DecodeGateway,
    DecodeRequest,
    FleetGateway,
    Gateway,
    HostLoad,
    Request,
    SLOConfig,
    WorkStealer,
)
from repro_torch.serving.continuous import ContinuousScheduler
from repro_torch.serving.gateway import BatchScheduler, _Entry
from repro_torch.serving.slo import PausedCarry, is_urgent, urgency_key
from repro_torch.serving.toy import CountingToySampler, FakeClock, ToyDecodeEngine

BUDGETS = (4, 8, 16)
TOL = 2e-5


class CarrySampler(CountingToySampler):
    def __init__(self, budgets=BUDGETS, seed=0, jitter=0.1, theta=None):
        super().__init__(budgets=budgets, seed=seed, jitter=jitter, theta=theta)


class TickingSampler(CarrySampler):
    """Each batch-level forward advances the fake clock — dispatches take
    simulated time, so the registry's dispatch histograms (the admission
    cost model) see deterministic milliseconds."""

    def __init__(self, clock, ms_per_forward=5.0, **kw):
        super().__init__(**kw)
        self._clock = clock
        self._ms = ms_per_forward

    def on_forward(self):
        super().on_forward()
        self._clock.advance(self._ms / 1e3)


def _x0(i, shape=(2,)):
    return np.random.default_rng(100 + i).standard_normal(shape).astype(np.float32)


def _entry(uid, served=4, t=0.0, deadline=None, priority=0):
    return _Entry(uid=uid, tokens=None, x0=np.zeros((2,), np.float32), requested=served,
                  served=served, shape_key=(None, (2,)), t_submit=t, future=None,
                  deadline=deadline, priority=priority)


# ---------------------------------------------------------------------------
# pure policy (slo.py)
# ---------------------------------------------------------------------------


def test_urgency_key_orders_priority_deadline_then_fifo():
    plain_a, plain_b = _entry(0, t=0.0), _entry(1, t=1.0)
    dl = _entry(2, t=2.0, deadline=5.0)
    hot = _entry(3, t=3.0, priority=2)
    got = sorted([plain_b, hot, dl, plain_a], key=urgency_key)
    assert [e.uid for e in got] == [3, 2, 0, 1]
    assert sorted([plain_b, plain_a], key=urgency_key) == [plain_a, plain_b]


def test_is_urgent():
    assert not is_urgent(_entry(0))
    assert is_urgent(_entry(1, deadline=1.0))
    assert is_urgent(_entry(2, priority=1))


def test_slo_config_switches_match_the_reference():
    assert SLOConfig() == SLOConfig(admission=True, shedding=True, preemption=True,
                                    slack_ms=0.0, default_cost_ms=0.0)
    ref = JaxSLOConfig()
    assert [getattr(SLOConfig(), f) for f in ("admission", "shedding", "preemption",
                                              "slack_ms", "default_cost_ms")] == \
        [getattr(ref, f) for f in ("admission", "shedding", "preemption", "slack_ms",
                                   "default_cost_ms")]
    paused = PausedCarry(step=4, x0=np.zeros(2), U=np.zeros((16, 2)), x=np.ones(2))
    assert paused.step == 4 and paused.U.shape == (16, 2)


# ---------------------------------------------------------------------------
# BatchScheduler in SLO mode
# ---------------------------------------------------------------------------


def test_slo_scheduler_flushes_under_deadline_pressure():
    s = BatchScheduler(max_batch=4, max_wait_ms=100.0, slo_aware=True)
    s.lead_ms = 5.0
    young = [_entry(0, t=0.0, deadline=0.008)]
    assert s.plan(young, now=0.004) != []
    assert s.plan([_entry(0, t=0.0)], now=0.004) == []
    legacy = BatchScheduler(max_batch=4, max_wait_ms=100.0)
    assert legacy.plan(young, now=0.004) == []


def test_slo_scheduler_orders_batches_by_urgency():
    s = BatchScheduler(max_batch=4, max_wait_ms=10.0, slo_aware=True)
    pending = [_entry(0, served=4), _entry(1, served=8, priority=3)]
    batches = s.plan(pending, now=0.0, force=True)
    assert len(batches) == 2
    assert batches[0].entries[0].uid == 1


def test_plan_preemptions_pairs_urgent_with_weakest_victims():
    s = ContinuousScheduler(max_slots=2, boundaries=BUDGETS)
    active = [(0, _entry(0, served=16, t=0.0)), (1, _entry(1, served=16, t=0.0))]
    urgent = _entry(5, served=8, priority=1)
    pairs = s.plan_preemptions([urgent], boundary=4, active=active, free_slots=0,
                               shape_key=(None, (2,)))
    assert [(si, v.uid, e.uid) for si, v, e in pairs] == [(1, 1, 5)]
    assert s.plan_preemptions([urgent], 4, active, free_slots=1,
                              shape_key=(None, (2,))) == []
    assert s.plan_preemptions([_entry(6, served=8)], 4, active, 0, (None, (2,))) == []
    late = _entry(7, served=5, priority=1)
    assert s.plan_preemptions([late], 4, active, 0, (None, (2,))) == []


# ---------------------------------------------------------------------------
# admission control + shedding + goodput (flush gateway, fake clock)
# ---------------------------------------------------------------------------


def test_admission_rejects_infeasible_deadline_with_default_cost():
    clock = FakeClock()
    gw = Gateway(CarrySampler(), max_batch=4, max_wait_ms=10.0, clock=clock,
                 slo=SLOConfig(default_cost_ms=10.0))
    with pytest.raises(AdmissionRejected) as ei:
        gw.submit(Request(budget=4, x0=_x0(0), deadline_ms=5.0))
    assert ei.value.estimated_ms == 10.0
    ok = gw.submit(Request(budget=4, x0=_x0(1), deadline_ms=1000.0))
    best_effort = gw.submit(Request(budget=4, x0=_x0(2)))
    s = gw.stats()
    assert s["rejected"] == 1 and s["submitted"] == 2
    gw.pump(force=True)
    assert ok.result(1).meta["served_budget"] == 4
    assert best_effort.result(1) is not None


def test_admission_cost_model_calibrates_from_observed_dispatches():
    clock = FakeClock()
    sampler = TickingSampler(clock, ms_per_forward=5.0)
    gw = Gateway(sampler, max_batch=2, max_wait_ms=10.0, clock=clock, slo=SLOConfig())
    f = gw.submit(Request(budget=4, x0=_x0(0), deadline_ms=1.0))
    gw.pump(force=True)
    assert f.result(1) is not None
    assert gw._dispatch_cost_ms() >= 20.0
    with pytest.raises(AdmissionRejected):
        gw.submit(Request(budget=4, x0=_x0(1), deadline_ms=1.0))
    for i in range(4):
        gw.submit(Request(budget=4, x0=_x0(2 + i), deadline_ms=10_000.0))
    assert gw._estimate_wait_ms(None) >= 3 * 20.0


def test_continuous_cost_model_reads_device_time_per_settle():
    """The continuous tier's estimate is the observed device time per
    settled request times the work ahead; before any settle it is the flush
    model's."""
    clock = FakeClock()
    sampler = TickingSampler(clock, ms_per_forward=5.0)
    gw = ContinuousGateway(sampler, max_slots=2, max_wait_ms=10.0, clock=clock,
                           slo=SLOConfig(default_cost_ms=3.0))
    assert gw._estimate_wait_ms(None) == 3.0
    gw.submit(Request(budget=4, x0=_x0(0)))
    gw.drain()
    s = gw.metrics.snapshot()["device_dispatch_ms"]
    assert s["count"] == 1 and s["sum"] == pytest.approx(20.0)
    assert gw._estimate_wait_ms(None) == pytest.approx(20.0)   # nothing ahead


def test_shedding_fails_expired_queued_entries():
    clock = FakeClock()
    gw = Gateway(CarrySampler(), max_batch=4, max_wait_ms=1000.0, clock=clock,
                 slo=SLOConfig())
    doomed = gw.submit(Request(budget=4, x0=_x0(0), deadline_ms=10.0))
    clock.advance(0.05)
    gw.pump()
    with pytest.raises(DeadlineExceeded):
        doomed.result(1)
    s = gw.stats()
    assert s["deadline_misses"] == 1 and s["failed"] == 1
    assert s["completed"] == 0 and s["goodput"] == 0


def test_goodput_and_hit_rate_accounting():
    clock = FakeClock()
    sampler = TickingSampler(clock, ms_per_forward=1.0)
    gw = Gateway(sampler, max_batch=4, max_wait_ms=10.0, clock=clock, slo=SLOConfig())
    on_time = gw.submit(Request(budget=4, x0=_x0(0), deadline_ms=1000.0))
    late = gw.submit(Request(budget=4, x0=_x0(1), deadline_ms=2.0))
    gw.pump(force=True)
    assert on_time.result(1) is not None and late.result(1) is not None
    s = gw.stats()
    assert s["goodput"] == 1 and s["deadline_misses"] == 1
    assert s["completed"] == 2
    assert s["deadline_hit_rate"] == pytest.approx(0.5)


def test_slo_none_keeps_legacy_behavior_but_records_deadlines():
    clock = FakeClock()
    gw = Gateway(CarrySampler(), max_batch=4, max_wait_ms=10.0, clock=clock)
    f = gw.submit(Request(budget=4, x0=_x0(0), deadline_ms=0.001))
    clock.advance(1.0)
    gw.pump(force=True)
    assert f.result(1) is not None
    s = gw.stats()
    assert s["rejected"] == 0 and s["completed"] == 1
    assert s["deadline_misses"] == 1 and s["goodput"] == 0


# ---------------------------------------------------------------------------
# preemption at exit boundaries (continuous gateway)
# ---------------------------------------------------------------------------


def test_preempted_request_resumes_bit_identical():
    clock = FakeClock()
    sampler = CarrySampler()
    gw = ContinuousGateway(sampler, max_slots=2, max_wait_ms=10.0, clock=clock,
                           slo=SLOConfig())
    lows = [gw.submit(Request(budget=16, x0=_x0(i))) for i in range(2)]
    assert gw.pump(force=True) == 1
    hot = gw.submit(Request(budget=8, x0=_x0(2), priority=1))
    assert gw.pump() >= 1                        # leg 0..4: preempt uid 1
    assert gw.stats()["preemptions"] == 1
    victim = next(e for e in gw.queue.snapshot() if e.paused is not None)
    assert isinstance(victim.paused.U, np.ndarray) and victim.paused.step == 4
    assert not any(f.done() for f in lows) and not hot.done()
    gw.pump()                                    # leg 4..8: hot exits
    assert hot.done()
    gw.pump()                                    # leg 8..16: both lows exit
    assert all(f.done() for f in lows)
    got = np.stack([f.result(1).latents for f in lows])
    direct16 = CarrySampler().sample_from(None, np.stack([_x0(0), _x0(1)]), 16).numpy()
    np.testing.assert_array_equal(got, direct16)
    direct8 = CarrySampler().sample_from(None, np.stack([_x0(2), _x0(2)]), 8).numpy()
    np.testing.assert_array_equal(hot.result(1).latents, direct8[0])
    assert sampler.forwards == 16 + 4 + 4
    s = gw.stats()
    assert s["completed"] == 3 and s["failed"] == 0
    assert gw.queue.depth() == 0 and s["inflight"] == 0


def test_preemption_off_leaves_trajectory_untouched():
    clock = FakeClock()
    gw = ContinuousGateway(CarrySampler(), max_slots=2, max_wait_ms=10.0, clock=clock,
                           slo=SLOConfig(preemption=False))
    lows = [gw.submit(Request(budget=16, x0=_x0(i))) for i in range(2)]
    gw.pump(force=True)
    gw.submit(Request(budget=8, x0=_x0(2), priority=1))
    gw.pump()
    assert gw.stats()["preemptions"] == 0
    for _ in range(8):
        gw.pump(force=True)
    assert all(f.done() for f in lows)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def test_flow_stream_partials_are_nested_early_exits():
    clock = FakeClock()
    gw = ContinuousGateway(CarrySampler(), max_slots=2, max_wait_ms=10.0, clock=clock)
    stream = gw.submit_stream(budget=16, x0=_x0(0))
    for _ in range(4):
        gw.pump(force=True)
    chunks = stream.chunks(timeout=1)
    assert [c.final for c in chunks] == [False, False, True]
    assert [c.meta["boundary"] for c in chunks[:-1]] == [4, 8]
    ref = CarrySampler()
    x0 = np.stack([_x0(0)])
    for c, b in zip(chunks[:-1], (4, 8)):
        np.testing.assert_array_equal(c.payload, ref.sample_from(None, x0, b)[0].numpy())
    final = chunks[-1].payload
    assert final is stream.result(1)
    np.testing.assert_array_equal(final.latents, ref.sample_from(None, x0, 16)[0].numpy())


def test_decode_stream_tokens_match_solo_oracle():
    clock = FakeClock()
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=2, prefill_chunk=0, clock=clock)
    prompt, n = [3, 5, 11], 6
    stream = gw.submit_stream(prompt=prompt, max_tokens=n)
    plain = gw.submit(DecodeRequest(prompt=prompt, max_tokens=n))
    for _ in range(32):
        gw.pump()
    chunks = stream.chunks(timeout=1)
    assert chunks[-1].final
    assert [c.payload for c in chunks[:-1]] == ToyDecodeEngine().solo_tokens(prompt, n)
    np.testing.assert_array_equal(chunks[-1].payload.tokens, plain.result(1).tokens)
    assert [c.meta["index"] for c in chunks[:-1]] == list(range(n))


def test_stream_surfaces_failures_like_the_future():
    clock = FakeClock()

    class Exploding(CarrySampler):
        def sample_from(self, batch, x0, budget):
            raise RuntimeError("boom")

    gw = Gateway(Exploding(), max_batch=2, max_wait_ms=10.0, clock=clock)
    stream = gw.submit_stream(budget=4, x0=_x0(0))
    gw.pump(force=True)
    with pytest.raises(RuntimeError, match="boom"):
        stream.chunks(timeout=1)


def test_flush_stream_final_is_the_response():
    """Through the flush gateway a stream carries no partial: its one chunk
    is the settled response itself."""
    gw = Gateway(CarrySampler(), max_batch=2, max_wait_ms=10.0, clock=FakeClock())
    stream = gw.submit_stream(budget=8, x0=_x0(3))
    gw.pump(force=True)
    chunks = stream.chunks(timeout=1)
    assert len(chunks) == 1 and chunks[0].final
    assert chunks[0].payload is stream.result(1)


# ---------------------------------------------------------------------------
# decode admission, and the steal hooks on the flow gateway
# ---------------------------------------------------------------------------


def test_decode_admission_and_deadline_metrics():
    clock = FakeClock()
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=2, prefill_chunk=0, clock=clock,
                       slo=SLOConfig(default_cost_ms=2.0))
    with pytest.raises(AdmissionRejected):
        gw.submit(DecodeRequest(prompt=[3], max_tokens=4, deadline_ms=5.0))
    ok = gw.submit(DecodeRequest(prompt=[3], max_tokens=4, deadline_ms=500.0))
    for _ in range(16):
        gw.pump()
    assert ok.result(1).meta["finish_reason"] == "length"
    s = gw.stats()
    assert s["rejected"] == 1 and s["goodput"] == 1


def test_decode_urgent_requests_admitted_first():
    clock = FakeClock()
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=1, prefill_chunk=0, clock=clock,
                       slo=SLOConfig())
    low = gw.submit(DecodeRequest(prompt=[3], max_tokens=2))
    hot = gw.submit(DecodeRequest(prompt=[5], max_tokens=2, priority=1))
    for _ in range(16):
        gw.pump()
    assert hot.result(1).meta["join_step"] < low.result(1).meta["join_step"]


def test_steal_pops_most_urgent_and_load_counts_urgent():
    gw = Gateway(CarrySampler(), max_batch=4, max_wait_ms=10.0, clock=FakeClock())
    gw.submit(Request(budget=4, x0=_x0(0)))
    hot = gw.submit(Request(budget=4, x0=_x0(1), priority=5))
    dl = gw.submit(Request(budget=4, x0=_x0(2), deadline_ms=50.0))
    assert gw.load() == HostLoad(queue_depth=3, inflight=0, urgent=2)
    taken = gw.steal(2)
    assert [e.uid for e in taken] == [hot.uid, dl.uid]


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


def _preempt_and_stream(gw, req, x0s):
    """Two low-priority requests at 16 (one streamed), a priority-1 request
    at 8 after the trajectory opens, then drain."""
    lows = [gw.submit_stream(budget=16, x0=x0s[0]), gw.submit(req(budget=16, x0=x0s[1]))]
    gw.pump(force=True)
    hot = gw.submit(req(budget=8, x0=x0s[2], priority=1))
    gw.drain()
    chunks = lows[0].chunks(timeout=5)
    return [lows[0].result(5), lows[1].result(5), hot.result(5)], chunks, gw.stats()


def test_preemption_and_streaming_match_the_reference():
    ref = JaxCountingToy(budgets=BUDGETS)
    port = CarrySampler(theta=anytime_params_from_numpy(*(np.asarray(p) for p in ref.theta)))
    x0s = [_x0(i) for i in range(3)]
    jgw = JaxContinuousGateway(ref, max_slots=2, max_wait_ms=10.0, clock=JaxFakeClock(),
                               slo=JaxSLOConfig())
    tgw = ContinuousGateway(port, max_slots=2, max_wait_ms=10.0, clock=FakeClock(),
                            slo=SLOConfig())
    jres, jchunks, jstats = _preempt_and_stream(jgw, JaxRequest,
                                                [jnp.asarray(x) for x in x0s])
    tres, tchunks, tstats = _preempt_and_stream(tgw, Request, x0s)
    for j, t in zip(jres, tres):
        assert {k: v for k, v in t.meta.items() if k != "wait_ms"} == \
            {k: v for k, v in j.meta.items() if k != "wait_ms"}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents), atol=TOL, rtol=TOL)
    assert [c.meta for c in tchunks[:-1]] == [c.meta for c in jchunks[:-1]]
    for j, t in zip(jchunks[:-1], tchunks[:-1]):
        np.testing.assert_allclose(t.payload, np.asarray(j.payload), atol=TOL, rtol=TOL)
    for key in ("preemptions", "joins", "legs", "forwards", "completed", "failed"):
        assert tstats[key] == jstats[key], key
    assert tstats["preemptions"] == 1 and port.forwards == ref.forwards


def test_fleet_stream_and_urgent_stealing():
    """``tests/test_slo.py``'s fleet case: a streamed submit through the
    fleet terminates with the future's response, and the stealer robs a
    shallower shard holding urgent work before a deeper plain one."""
    clocks = [FakeClock(), FakeClock()]
    gws = {f"h{i}": Gateway(CarrySampler(), max_batch=4, max_wait_ms=10.0, clock=clocks[i])
           for i in range(2)}
    fleet = FleetGateway(gws, steal=False)
    stream = fleet.submit_stream(budget=4, x0=_x0(0))
    fleet.pump(force=True)
    chunks = stream.chunks(timeout=1)
    assert chunks[-1].final
    np.testing.assert_array_equal(np.asarray(chunks[-1].payload.latents),
                                  np.asarray(stream.result(1).latents))
    stealer = WorkStealer(min_queue=2)
    loads = {"a": HostLoad(queue_depth=6, inflight=0),
             "b": HostLoad(queue_depth=3, inflight=0, urgent=2),
             "c": HostLoad(queue_depth=0, inflight=0)}
    assert stealer.plan(loads) == [("b", "c", 2)]
    flat = {"a": HostLoad(queue_depth=6, inflight=0),
            "b": HostLoad(queue_depth=3, inflight=0),
            "c": HostLoad(queue_depth=0, inflight=0)}
    assert stealer.plan(flat) == [("a", "c", 3)]    # legacy: deepest wins
