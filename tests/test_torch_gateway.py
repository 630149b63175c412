"""The port's flow gateway against the JAX reference, on the CPU.

Every case of ``tests/test_gateway.py`` is mirrored on the port's
``CountingToySampler`` and on a 2-layer backbone (yi-6b's smoke config,
f32, the reference's params through ``params_from_jax``), except the
sharded case (``mesh=``: ``tests/test_torch_placement.py``) and the Pallas update
function (the port always updates through its own ``ns_update`` path).
In-port bit-identity is exact, as in the reference. Parity cases send the
same ``Request(x0=...)`` traffic through the reference's ``Gateway`` and the
port's, on toy samplers that share the reference's jittered solver or on
the shared backbone: latents within ``tests/test_kernels.py``'s f32 2e-5
(scaled by NFE on the backbone, as ``tests/test_torch_serve.py`` does) and
equal serving metadata.
"""
import threading
import time

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
from repro.serving import Gateway as JaxGateway
from repro.serving import Request as JaxRequest
from repro.serving.toy import CountingToySampler as JaxCountingToy
from repro.serving.toy import FakeClock as JaxFakeClock
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.core.anytime import anytime_params_from_numpy, init_anytime
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import AnytimeFlowSampler, DrainTimeout, Gateway, Request
from repro_torch.serving.engine import fold_in
from repro_torch.serving.gateway import BatchScheduler, request_noise
from repro_torch.serving.toy import CountingToySampler, FakeClock
from repro_torch.solvers import SolverArtifact, SolverSpec

BUDGETS = (2, 4)
TOL = 2e-5


def _gateway(sampler=None, **kw):
    clock = FakeClock()
    sampler = sampler or CountingToySampler()
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 10.0)
    gw = Gateway(sampler, clock=clock, **kw)
    return gw, sampler, clock


def _x0(i, shape=(2,)):
    return np.random.default_rng(100 + i).standard_normal(shape).astype(np.float32)


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# BatchScheduler (pure planning)
# ---------------------------------------------------------------------------


def test_bucket_sizes_are_powers_of_two_up_to_max_batch():
    s = BatchScheduler(max_batch=8)
    assert [s.bucket(k) for k in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    s6 = BatchScheduler(max_batch=6)
    assert [s6.bucket(k) for k in (3, 5, 6)] == [4, 6, 6]
    with pytest.raises(ValueError):
        s.bucket(9)


def test_scheduler_validates_config():
    with pytest.raises(ValueError):
        BatchScheduler(max_batch=0)
    with pytest.raises(ValueError):
        BatchScheduler(policy="sometimes")


def test_use_mixed_single_budget_never_merges():
    s = BatchScheduler(max_batch=8, policy="always", can_mix=True, top_budget=16)
    assert not s._use_mixed([4], total=3)


def test_use_mixed_all_equal_budgets_form_one_group():
    gw, sampler, clock = _gateway(max_batch=4, mixed_budget_policy="always")
    futs = [gw.submit(Request(budget=4, x0=_x0(i))) for i in range(3)]
    clock.advance(1.0)
    assert gw.pump() == 1
    assert all(not f.result(timeout=5).meta["mixed"] for f in futs)
    assert gw.stats()["mixed_batches"] == 0 and sampler.forwards == 4


def test_use_mixed_respects_policy_and_missing_top_budget():
    s = BatchScheduler(max_batch=8, policy="never", can_mix=True, top_budget=16)
    assert not s._use_mixed([2, 4], total=2)
    s2 = BatchScheduler(max_batch=8, policy="auto", can_mix=True, top_budget=None)
    assert not s2._use_mixed([2, 4], total=2)
    s3 = BatchScheduler(max_batch=8, policy="auto", can_mix=False, top_budget=2)
    assert not s3._use_mixed([2, 4], total=2)


def test_use_mixed_totals_exceeding_max_batch_count_every_chunk():
    s = BatchScheduler(max_batch=2, policy="auto", can_mix=True, top_budget=8)
    assert not s._use_mixed([2, 4, 8], total=5)      # 3 chunks x 8 > 14
    assert s._use_mixed([2, 4, 8], total=2)          # 1 chunk x 8 < 14
    s.top_budget = 3
    assert s._use_mixed([2, 4, 8], total=5)          # 3 x 3 < 14


# ---------------------------------------------------------------------------
# Coalescing + flush behaviour (fake clock, manual pump)
# ---------------------------------------------------------------------------


def test_full_batch_flushes_immediately_without_wait():
    gw, sampler, clock = _gateway()
    f0 = gw.submit(Request(budget=2, x0=_x0(0)))
    assert gw.pump() == 0 and not f0.done()
    f1 = gw.submit(Request(budget=2, x0=_x0(1)))
    assert gw.pump() == 1
    assert f0.done() and f1.done()
    assert sampler.forwards == 2


def test_coalesces_by_budget_not_arrival_order():
    gw, sampler, clock = _gateway()
    futs = [gw.submit(Request(budget=b, x0=_x0(i)))
            for i, b in enumerate([2, 4, 2, 4])]
    assert gw.pump() == 2
    for f, b in zip(futs, [2, 4, 2, 4]):
        assert f.result(timeout=5).meta["served_budget"] == b
        assert f.result(timeout=5).meta["batch_real"] == 2
    assert sampler.forwards == 6
    assert gw.stats()["forwards"] == sampler.forwards


def test_partial_batch_flushes_only_after_max_wait():
    gw, sampler, clock = _gateway(max_batch=4)
    fut = gw.submit(Request(budget=2, x0=_x0(0)))
    clock.advance(0.005)
    assert gw.pump() == 0 and not fut.done()
    clock.advance(0.006)
    assert gw.pump() == 1
    assert fut.result(timeout=5).meta["wait_ms"] >= 10.0
    assert fut.result(timeout=5).meta["batch_real"] == 1


def test_gateway_output_bit_identical_to_direct_sampler():
    """Coalesced + padded rows equal a direct ``sample_from`` of the 3 rows,
    and come back as host numpy rows."""
    gw, sampler, clock = _gateway(max_batch=4)
    x0s = [_x0(i) for i in range(3)]
    futs = [gw.submit(Request(budget=4, x0=x)) for x in x0s]
    clock.advance(1.0)
    assert gw.pump() == 1
    direct = sampler.sample_from(None, np.stack(x0s), 4)
    for f, d in zip(futs, direct):
        assert isinstance(f.result(timeout=5).latents, np.ndarray)
        _bits(f.result(timeout=5).latents, d)
        assert f.result(timeout=5).meta["batch_padded"] == 4


def test_coalesced_batch_costs_exactly_m_forwards():
    gw, sampler, clock = _gateway(max_batch=4)
    for i in range(4):
        gw.submit(Request(budget=4, x0=_x0(i)))
    assert gw.pump() == 1
    assert sampler.forwards == 4
    s = gw.stats()
    assert s["forwards"] == 4 and s["completed"] == 4
    assert s["nfe_per_request"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Mixed-budget policy
# ---------------------------------------------------------------------------


def test_mixed_flush_rides_shared_trajectory_when_cheaper():
    gw, sampler, clock = _gateway(max_batch=4)
    f2 = gw.submit(Request(budget=2, x0=_x0(0)))
    f4 = gw.submit(Request(budget=4, x0=_x0(1)))
    clock.advance(1.0)
    assert gw.pump() == 1
    assert sampler.forwards == 4
    for f, b in [(f2, 2), (f4, 4)]:
        meta = f.result(timeout=5).meta
        assert meta["mixed"] and meta["served_budget"] == b
        assert meta["nfe_batch"] == 4
    outs = CountingToySampler().sample_all_from(None, np.stack([_x0(0), _x0(1)]))
    _bits(f2.result(timeout=5).latents, outs[2][0])
    _bits(f4.result(timeout=5).latents, outs[4][1])
    assert gw.stats()["mixed_batches"] == 1


def test_mixed_policy_never_dispatches_per_budget():
    gw, sampler, clock = _gateway(max_batch=4, mixed_budget_policy="never")
    gw.submit(Request(budget=2, x0=_x0(0)))
    gw.submit(Request(budget=4, x0=_x0(1)))
    clock.advance(1.0)
    assert gw.pump() == 2
    assert sampler.forwards == 6
    assert gw.stats()["mixed_batches"] == 0


def test_mixed_auto_respects_cost_model():
    sampler = CountingToySampler(budgets=(2, 4, 16))
    gw, _, clock = _gateway(sampler, max_batch=4)
    gw.submit(Request(budget=2, x0=_x0(0)))
    gw.submit(Request(budget=4, x0=_x0(1)))
    clock.advance(1.0)
    assert gw.pump() == 2 and sampler.forwards == 6
    sampler2 = CountingToySampler(budgets=(2, 4, 16))
    gw2, _, clock2 = _gateway(sampler2, max_batch=4, mixed_budget_policy="always")
    gw2.submit(Request(budget=2, x0=_x0(0)))
    gw2.submit(Request(budget=4, x0=_x0(1)))
    clock2.advance(1.0)
    assert gw2.pump() == 1 and sampler2.forwards == 16


def test_mixed_auto_accounts_for_chunking():
    sampler = CountingToySampler(budgets=(2, 4, 8, 16))
    gw, _, clock = _gateway(sampler, max_batch=2)
    for i, b in enumerate((2, 4, 8, 16)):
        gw.submit(Request(budget=b, x0=_x0(i)))
    clock.advance(1.0)
    assert gw.pump() == 4
    assert sampler.forwards == 30
    assert gw.stats()["mixed_batches"] == 0


# ---------------------------------------------------------------------------
# Budget drift metadata, strict mode, noise
# ---------------------------------------------------------------------------


def test_budget_drift_recorded_in_response_metadata():
    gw, sampler, clock = _gateway(max_batch=1)
    fut = gw.submit(Request(budget=3, x0=_x0(0)))
    gw.pump()
    meta = fut.result(timeout=5).meta
    assert meta["requested_budget"] == 3
    assert meta["served_budget"] == 2


def test_strict_nfe_rejects_at_submit():
    gw, sampler, clock = _gateway(strict_nfe=True)
    with pytest.raises(ValueError):
        gw.submit(Request(budget=3, x0=_x0(0)))
    assert gw.queue.depth() == 0


def test_submit_requires_tokens_or_x0():
    gw, _, _ = _gateway()
    with pytest.raises(ValueError):
        gw.submit(Request(budget=2))


def test_mesh_is_refused_naming_its_item():
    """mesh= serves since placement was ported (tests/test_torch_placement.py);
    what is not a DeviceMesh with the serving axes is refused, naming what
    it takes."""
    with pytest.raises(TypeError, match="DeviceMesh with \\('data', 'model'\\)"):
        Gateway(CountingToySampler(), mesh=object())


# ---------------------------------------------------------------------------
# Drain / lifecycle / threaded serving
# ---------------------------------------------------------------------------


def test_drain_flushes_everything_and_closes_intake():
    gw, sampler, clock = _gateway(max_batch=4)
    futs = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(3)]
    gw.drain()
    assert all(f.done() for f in futs)
    with pytest.raises(RuntimeError):
        gw.submit(Request(budget=2, x0=_x0(9)))


def test_submit_during_pump_is_never_lost():
    gw, sampler, clock = _gateway(max_batch=2)
    f0 = gw.submit(Request(budget=2, x0=_x0(0)))
    orig_plan = gw.scheduler.plan
    late = {}

    def plan_then_push(pending, now, force=False):
        out = orig_plan(pending, now, force)
        if "f" not in late:
            late["f"] = gw.submit(Request(budget=2, x0=_x0(1)))
        return out

    gw.scheduler.plan = plan_then_push
    assert gw.pump() == 0
    assert gw.queue.depth() == 2
    assert gw.pump() == 1
    assert f0.done() and late["f"].done()


def test_failed_batch_propagates_to_futures():
    class Exploding(CountingToySampler):
        def sample_from(self, batch, x0, budget):
            raise RuntimeError("boom")

    gw, _, clock = _gateway(Exploding())
    futs = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(2)]
    gw.pump()
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=5)
    assert gw.stats()["failed"] == 2


def test_mid_drain_failure_surfaces_into_affected_futures():
    class Exploding(CountingToySampler):
        def sample_from(self, batch, x0, budget):
            if budget == 2:
                raise RuntimeError("boom")
            return super().sample_from(batch, x0, budget)

    gw, _, clock = _gateway(Exploding(), max_batch=2, mixed_budget_policy="never")
    f2s = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(2)]
    f4s = [gw.submit(Request(budget=4, x0=_x0(2 + i))) for i in range(2)]
    f2s[0].cancel()
    gw.drain()
    assert all(f.done() for f in f2s + f4s)
    with pytest.raises(RuntimeError, match="boom"):
        f2s[1].result(timeout=5)
    for f in f4s:
        assert f.result(timeout=5).meta["served_budget"] == 4


def test_cancelled_future_does_not_strand_batch_mates():
    gw, sampler, clock = _gateway(max_batch=2)
    f0 = gw.submit(Request(budget=2, x0=_x0(0)))
    f1 = gw.submit(Request(budget=2, x0=_x0(1)))
    f0.cancel()
    assert gw.pump() == 1
    assert f1.result(timeout=5).meta["served_budget"] == 2


def test_stats_occupancy_under_partial_flushes():
    gw, sampler, clock = _gateway(max_batch=4)
    for i in range(3):
        gw.submit(Request(budget=2, x0=_x0(i)))
    clock.advance(1.0)
    assert gw.pump() == 1
    assert gw.stats()["occupancy"] == pytest.approx(3 / 4)
    for i in range(4):
        gw.submit(Request(budget=2, x0=_x0(10 + i)))
    assert gw.pump() == 1
    s = gw.stats()
    assert s["occupancy"] == pytest.approx((3 + 4) / (4 + 4))
    assert gw.stats_raw.real_rows == 7 and gw.stats_raw.padded_rows == 8
    gw.submit(Request(budget=2, x0=_x0(20)))
    clock.advance(1.0)
    assert gw.pump() == 1
    assert gw.stats()["occupancy"] == pytest.approx((3 + 4 + 1) / (4 + 4 + 1))


def test_threaded_serve_forever_resolves_futures():
    sampler = CountingToySampler()
    gw = Gateway(sampler, max_batch=2, max_wait_ms=5.0)
    gw.start()
    futs = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(3)]
    for f in futs:
        assert f.result(timeout=30).latents.shape == (2,)
    gw.shutdown(timeout=30)
    assert gw.stats()["completed"] == 3


def test_drain_waits_for_inflight_batch():
    release = threading.Event()
    entered = threading.Event()

    class Blocking(CountingToySampler):
        def sample_from(self, batch, x0, budget):
            entered.set()
            release.wait(timeout=5)
            return super().sample_from(batch, x0, budget)

    gw, _, clock = _gateway(Blocking(), max_batch=2)
    gw.start()
    futs = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(2)]
    assert entered.wait(timeout=5)
    assert gw.queue.depth() == 0
    t = threading.Thread(target=gw.drain)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()
    assert not any(f.done() for f in futs)
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert all(f.done() for f in futs)
    gw.stop()


def test_dispatches_never_overlap_across_threads():
    """One dispatch at a time: while the serve thread's batch is in the
    sampler, a draining thread's batch waits for it (two threads launching
    torch work at once would interleave on one stream and share forward-mode
    AD state)."""
    release, entered, lock = threading.Event(), threading.Event(), threading.Lock()
    active, peak = [0], [0]

    class Tracking(CountingToySampler):
        def sample_from(self, batch, x0, budget):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            entered.set()
            release.wait(timeout=5)
            try:
                return super().sample_from(batch, x0, budget)
            finally:
                with lock:
                    active[0] -= 1

    gw, _, clock = _gateway(Tracking(), max_batch=2)
    gw.start()
    first = [gw.submit(Request(budget=2, x0=_x0(i))) for i in range(2)]
    assert entered.wait(timeout=5)              # a full batch is in the sampler
    second = gw.submit(Request(budget=4, x0=_x0(2)))
    t = threading.Thread(target=gw.drain)       # plans `second` at once
    t.start()
    time.sleep(0.05)
    assert peak[0] == 1 and not second.done()
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    for f in first + [second]:
        assert f.result(timeout=5).meta["batch_real"] >= 1
    assert peak[0] == 1
    gw.stop()


def test_drain_timeout_raises_with_stats_instead_of_hanging():
    gw, sampler, clock = _gateway()
    gw.submit(Request(budget=2, x0=_x0(0)))
    entry = gw.queue.snapshot()
    gw._take(entry)
    with pytest.raises(DrainTimeout) as err:
        gw.drain(timeout=0.05)
    assert "inflight=1" in str(err.value)
    assert err.value.stats["submitted"] == 1
    assert err.value.stats["completed"] == 0
    with pytest.raises(RuntimeError, match="draining"):
        gw.submit(Request(budget=2, x0=_x0(1)))
    gw._settle(1)
    entry[0].future.set_result(None)
    gw.drain(timeout=5.0)


def test_stats_snapshot_consistent_under_concurrent_traffic():
    gw, _, clock = _gateway(max_batch=4)
    gw.start()
    N, T = 20, 6

    def worker(base):
        for i in range(N):
            gw.submit(Request(budget=2, x0=_x0(base * N + i)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    bad = []

    def reader():
        for _ in range(300):
            s = gw.stats()
            if s["completed"] + s["failed"] > s["submitted"]:
                bad.append(s)

    r = threading.Thread(target=reader)
    for th in threads:
        th.start()
    r.start()
    for th in threads:
        th.join(timeout=30)
    r.join(timeout=30)
    gw.shutdown(timeout=30)
    assert not bad, f"inconsistent snapshots: {bad[:2]}"
    s = gw.stats()
    assert s["submitted"] == N * T
    assert s["completed"] == N * T


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
    art = SolverArtifact(spec=SolverSpec("midpoint", mode="anytime", budgets=BUDGETS),
                         params=init_anytime(None, BUDGETS, "nested"), val_psnr=0.0)

    def make_sampler():
        return AnytimeFlowSampler.from_artifact(art, params=params, cfg=cfg,
                                                sched=tsched.fm_ot())

    def make_reference():
        from repro.solvers import SolverArtifact as JaxArtifact
        from repro.solvers import SolverSpec as JaxSpec

        jart = JaxArtifact(spec=JaxSpec("midpoint", mode="anytime", budgets=BUDGETS),
                           params=jax_init_anytime(None, BUDGETS, "nested"), val_psnr=0.0)
        return JaxAnytimeSampler.from_artifact(jart, params=jparams, cfg=jcfg,
                                               sched=jsched.fm_ot())

    return cfg, tok, make_sampler, make_reference


def _bx0(seed, rows, cfg):
    return np.random.default_rng(seed).standard_normal(
        (rows, 8, cfg.latent_dim)).astype(np.float32)


def test_backbone_padded_batch_bit_identical(backbone):
    """3 coalesced requests padded to bucket 4: rows equal the direct 3-row
    ``sample_from`` call, and a direct call of each row alone."""
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    clock = FakeClock()
    gw = Gateway(sampler, max_batch=4, max_wait_ms=10.0, clock=clock)
    x0 = _bx0(5, 3, cfg)
    futs = [gw.submit(Request(tokens=torch.from_numpy(tok[i]), budget=2, x0=x0[i]))
            for i in range(3)]
    clock.advance(1.0)
    assert gw.pump() == 1
    direct = sampler.sample_from({"tokens": torch.from_numpy(tok[:3])}, x0, 2)
    for i, f in enumerate(futs):
        assert f.result(timeout=5).meta["batch_padded"] == 4
        _bits(f.result(timeout=5).latents, direct[i])
        alone = sampler.sample_from({"tokens": torch.from_numpy(tok[i:i + 1])},
                                    x0[i:i + 1], 2)
        _bits(f.result(timeout=5).latents, alone[0])


def test_backbone_bucket_reuses_one_dispatch_shape(backbone, monkeypatch):
    """Two same-bucket flushes are one (budget, bucket) program, captured
    once and replayed once (the card's CUDA graph stood in for by
    ``test_torch_programs.CPUGraph``): the ``jit_programs`` gauge counts 1
    and ``dispatches{program="b2/k4"}`` 2, as the reference counts one jit
    cache entry (``test_backbone_bucket_reuses_jit_program``)."""
    from test_torch_programs import CPUGraph

    from repro_torch.serving import programs

    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    gw = Gateway(sampler, max_batch=4, max_wait_ms=10.0, clock=FakeClock())
    for rnd in range(2):
        for i in range(3):
            gw.submit(Request(tokens=tok[i], budget=2, seed=rnd * 10 + i))
        gw.clock.advance(1.0)
        assert gw.pump() == 1
    snap = gw.metrics.snapshot()
    assert gw.stats()["jit_programs"] == 1
    assert snap['dispatches{program="b2/k4"}'] == 2
    assert (len(sampler.programs), sampler.programs.replays) == (1, 1)


def test_backbone_mixed_budget_end_to_end(backbone):
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    clock = FakeClock()
    gw = Gateway(sampler, max_batch=2, max_wait_ms=10.0, clock=clock)
    x0 = _bx0(6, 2, cfg)
    f2 = gw.submit(Request(tokens=tok[0], budget=2, x0=x0[0]))
    f4 = gw.submit(Request(tokens=tok[1], budget=4, x0=x0[1]))
    clock.advance(1.0)
    assert gw.pump() == 1
    outs = sampler.sample_all_from({"tokens": torch.from_numpy(tok[:2])}, x0)
    assert f2.result(timeout=5).meta["mixed"] and f4.result(timeout=5).meta["mixed"]
    assert f2.result(timeout=5).meta["nfe_batch"] == 4
    _bits(f2.result(timeout=5).latents, outs[2][0])
    _bits(f4.result(timeout=5).latents, outs[4][1])


def test_gateway_from_zoo_boots_without_redistilling(backbone):
    from repro_torch.serving import SolverZoo

    cfg, tok, make_sampler, _ = backbone
    params = make_sampler().params
    spec = SolverSpec("midpoint", mode="anytime", budgets=BUDGETS)
    zoo = SolverZoo(capacity=2)
    zoo.put(SolverArtifact(spec=spec, params=init_anytime(None, BUDGETS), val_psnr=0.0))
    gw = Gateway.from_zoo(zoo, spec, params=params, cfg=cfg, sched=tsched.fm_ot(),
                          max_batch=2, clock=FakeClock())
    assert zoo.stats.hits == 1 and zoo.stats.distills == 0
    assert gw.sampler.budgets == BUDGETS
    fut = gw.submit(Request(tokens=torch.zeros((8,), dtype=torch.long), budget=2, seed=0))
    gw.drain()
    assert fut.result(timeout=5).meta["served_budget"] == 2


def test_request_noise_depends_on_seed_not_batch(backbone):
    """A request without x0 draws (S, latent_dim) noise on a CPU generator
    seeded with ``Request.seed``, else ``fold_in(base seed, uid)``: the
    served row equals a direct ``sample_from`` of that draw, whatever batch
    it rode in."""
    cfg, tok, make_sampler, _ = backbone
    sampler = make_sampler()
    gw = Gateway(sampler, max_batch=4, max_wait_ms=10.0, clock=FakeClock(), seed=7)
    seeded = gw.submit(Request(tokens=tok[0], budget=2, seed=1000))
    folded = gw.submit(Request(tokens=tok[1], budget=2))
    gw.drain()
    for fut, row, seed in ((seeded, 0, 1000), (folded, 1, fold_in(7, folded.uid))):
        noise = torch.randn((8, cfg.latent_dim), generator=torch.Generator().manual_seed(seed))
        assert np.array_equal(request_noise(8, cfg.latent_dim, seed), noise.numpy())
        alone = sampler.sample_from({"tokens": torch.from_numpy(tok[row:row + 1])},
                                    noise[None], 2)
        _bits(fut.result(timeout=5).latents, alone[0])


# ---------------------------------------------------------------------------
# Parity with the reference's Gateway
# ---------------------------------------------------------------------------

META = ("requested_budget", "served_budget", "nfe_batch", "batch_real", "batch_padded",
        "mixed")


def _toy_pair(budgets):
    ref = JaxCountingToy(budgets=budgets)
    theta = anytime_params_from_numpy(*(np.asarray(p) for p in ref.theta))
    return ref, CountingToySampler(budgets=budgets, theta=theta)


def _serve_both(ref_sampler, port_sampler, traffic, **kw):
    """The same (budget, x0, tokens) traffic through both gateways, drained;
    returns both response lists and both stats."""
    out = []
    for gw_cls, req_cls, clock, sampler, tok_fn in (
            (JaxGateway, JaxRequest, JaxFakeClock(), ref_sampler, jnp.asarray),
            (Gateway, Request, FakeClock(), port_sampler, torch.from_numpy)):
        gw = gw_cls(sampler, clock=clock, **kw)
        futs = [gw.submit(req_cls(budget=b, x0=x0,
                                  tokens=None if t is None else tok_fn(t)))
                for b, x0, t in traffic]
        gw.drain()
        out.append(([f.result(timeout=30) for f in futs], gw.stats()))
    return out


@pytest.mark.parametrize("policy,max_batch,budgets,req", [
    ("auto", 4, (2, 4), (2, 4, 2, 4, 4, 2)),
    ("never", 2, (2, 4), (2, 4, 4, 2, 3)),
    ("always", 4, (2, 4, 16), (2, 4, 16)),
    ("auto", 2, (2, 4, 8, 16), (2, 4, 8, 16)),
])
def test_toy_traffic_matches_the_reference_gateway(policy, max_batch, budgets, req):
    ref, port = _toy_pair(budgets)
    traffic = [(b, _x0(i), None) for i, b in enumerate(req)]
    (jres, jstats), (tres, tstats) = _serve_both(
        ref, port, traffic, max_batch=max_batch, max_wait_ms=10.0,
        mixed_budget_policy=policy)
    for j, t in zip(jres, tres):
        assert {k: t.meta[k] for k in META} == {k: j.meta[k] for k in META}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents), atol=TOL, rtol=TOL)
    for key in ("batches", "mixed_batches", "forwards", "completed", "occupancy"):
        assert tstats[key] == jstats[key], key
    assert port.forwards == ref.forwards


def test_backbone_traffic_matches_the_reference_gateway(backbone):
    cfg, tok, make_sampler, make_reference = backbone
    x0 = _bx0(9, 5, cfg)
    traffic = [(b, x0[i], tok[i % 4]) for i, b in enumerate((2, 4, 2, 4, 4))]
    (jres, jstats), (tres, tstats) = _serve_both(
        make_reference(), make_sampler(), traffic, max_batch=2, max_wait_ms=10.0)
    for j, t in zip(jres, tres):
        assert {k: t.meta[k] for k in META} == {k: j.meta[k] for k in META}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents),
                                   atol=TOL * 4, rtol=TOL * 4)
    for key in ("batches", "mixed_batches", "forwards", "completed"):
        assert tstats[key] == jstats[key], key
