"""The port's fleet tier against the JAX reference, on the CPU.

Every case of ``tests/test_fleet.py`` up to its emulated-host section is
mirrored on the port's ``CountingToySampler`` (the emulated hosts split
XLA's CPU into devices, which has no torch twin). Fleet rows are held to
one lone port ``Gateway`` over the same trace to the bit, after steals and
across a join and a leave. Parity with the reference: ``FleetRouter``
homes key for key over host sets of one to eight hosts, across an ``add``
and a ``remove``; and the same explicit-x0 trace through both packages'
fleets, on toy samplers sharing the reference's jittered solver, within
``tests/test_kernels.py``'s f32 2e-5. The folded-seed path (requests
without ``x0``) draws torch noise, which cannot reproduce threefry, so it
is held fleet against lone port gateway only.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serving import FleetGateway as JaxFleetGateway
from repro.serving import FleetRouter as JaxFleetRouter
from repro.serving import Gateway as JaxGateway
from repro.serving import Request as JaxRequest
from repro.serving.toy import CountingToySampler as JaxCountingToy
from repro.serving.toy import FakeClock as JaxFakeClock
from repro_torch.core.anytime import anytime_params_from_numpy
from repro_torch.serving import (
    DrainTimeout,
    FleetGateway,
    FleetRouter,
    Gateway,
    HostLoad,
    Request,
    WorkStealer,
)
from repro_torch.serving.fleet import default_affinity, entry_affinity
from repro_torch.serving.toy import CountingToySampler, FakeClock

BUDGETS = (2, 4)
TOL = 2e-5


def _sampler(budgets=BUDGETS, theta=None):
    s = CountingToySampler(budgets=budgets, theta=theta)
    # the folded-seed path asks the sampler for the latent dim; the toy
    # field is 2-D
    s.cfg = SimpleNamespace(latent_dim=2)
    return s


def _fleet(n=4, budgets=BUDGETS, stealer=None, steal=False, **host_kw):
    """n toy hosts on ONE shared fake clock (simulated time is fleet-wide)."""
    clock = FakeClock()
    host_kw.setdefault("max_batch", 8)
    host_kw.setdefault("max_wait_ms", 10.0)
    host_kw.setdefault("mixed_budget_policy", "never")
    hosts = {f"h{i}": Gateway(_sampler(budgets), clock=clock, **host_kw)
             for i in range(n)}
    fleet = FleetGateway(hosts, stealer=stealer, steal=steal)
    return fleet, clock


def _single(budgets=BUDGETS, **kw):
    clock = FakeClock()
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 10.0)
    kw.setdefault("mixed_budget_policy", "never")
    return Gateway(_sampler(budgets), clock=clock, **kw), clock


def _x0(i, shape=(2,)):
    return np.random.default_rng(100 + i).standard_normal(shape).astype(np.float32)


def _drain_fake(gw, clock):
    """Drain on a fake clock: age every partial group, then pump to empty."""
    clock.advance(1.0)
    gw.drain()


def _bits(futs_a, futs_b):
    for a, b in zip(futs_a, futs_b, strict=True):
        np.testing.assert_array_equal(np.asarray(a.result().latents),
                                      np.asarray(b.result().latents))


# ---------------------------------------------------------------------------
# FleetRouter (pure HRW routing)
# ---------------------------------------------------------------------------


def test_router_deterministic_across_instances():
    hosts = ["h0", "h1", "h2", "h3"]
    keys = [("flow", b, None, (2,)) for b in (2, 4, 8, 16)] \
        + [("decode", 1 << i) for i in range(5)]
    a, b = FleetRouter(hosts), FleetRouter(hosts)
    assert [a.route(k) for k in keys] == [b.route(k) for k in keys]
    # the seed changes the assignment function (not necessarily every key)
    c = FleetRouter(hosts, seed=1)
    assert any(a.route(k) != c.route(k)
               for k in [("flow", i, None, (2,)) for i in range(64)])


def test_router_spreads_keys_across_hosts():
    r = FleetRouter(["h0", "h1", "h2", "h3"])
    homes = {r.route(("flow", i, None, (2,))) for i in range(64)}
    assert homes == {"h0", "h1", "h2", "h3"}


def test_router_remove_rehomes_only_the_removed_hosts_keys():
    r = FleetRouter(["h0", "h1", "h2", "h3"])
    keys = [("flow", i, None, (2,)) for i in range(64)]
    before = {k: r.route(k) for k in keys}
    r.remove("h2")
    for k in keys:
        if before[k] != "h2":
            assert r.route(k) == before[k]     # survivors keep their keys
        else:
            assert r.route(k) != "h2"


def test_router_add_moves_keys_only_to_the_new_host():
    r = FleetRouter(["h0", "h1", "h2"])
    keys = [("flow", i, None, (2,)) for i in range(64)]
    before = {k: r.route(k) for k in keys}
    r.add("h3")
    moved = {k for k in keys if r.route(k) != before[k]}
    assert moved and all(r.route(k) == "h3" for k in moved)


def test_router_validation():
    r = FleetRouter(["h0"])
    with pytest.raises(ValueError):
        r.add("h0")
    with pytest.raises(RuntimeError):
        FleetRouter().route(("flow", 2, None, (2,)))


def _parity_keys():
    keys = [("flow", b, None, (s, 8)) for b in (1, 2, 4, 8, 16) for s in range(1, 101)]
    keys += [("flow", b, (s,), (s, 4)) for b in (2, 8, 16) for s in range(1, 201)]
    keys += [("decode", 1 << i) for i in range(12)]
    keys += [("flow", None, (16,), None), ("flow", 4, None, None)]
    return keys


@pytest.mark.parametrize("n_hosts", range(1, 9))
@pytest.mark.parametrize("seed", [0, 7])
def test_router_homes_match_the_reference(n_hosts, seed):
    """The same key and the same live host set give the same home as the
    reference's router, for over 1000 keys, before and after a join and a
    leave."""
    keys = _parity_keys()
    assert len(keys) > 1000
    hosts = [f"h{i}" for i in range(n_hosts)]
    ours, ref = FleetRouter(hosts, seed=seed), JaxFleetRouter(hosts, seed=seed)

    def same():
        assert [ours.route(k) for k in keys] == [ref.route(k) for k in keys]

    same()
    for r in (ours, ref):
        r.add("late")
    same()
    if n_hosts > 1:
        for r in (ours, ref):
            r.remove("h0")
        same()


# ---------------------------------------------------------------------------
# Affinity keys
# ---------------------------------------------------------------------------


def test_default_affinity_groups_flow_by_budget_and_shape():
    a = default_affinity(Request(budget=4, x0=_x0(0)))
    b = default_affinity(Request(budget=4, x0=_x0(1)))
    assert a == b == ("flow", 4, None, (2,))
    assert default_affinity(Request(budget=2, x0=_x0(0))) != a
    # budget None resolves to the sampler's top budget at routing time
    assert default_affinity(Request(x0=_x0(0)), top_budget=4) == a
    toks = torch.zeros((3,), dtype=torch.int32)
    assert default_affinity(Request(tokens=toks, budget=4)) == ("flow", 4, (3,), None)


def test_default_affinity_buckets_decode_by_max_tokens():
    req = SimpleNamespace(prompt=[1, 2], max_tokens=5)
    assert default_affinity(req) == ("decode", 8)
    assert default_affinity(SimpleNamespace(prompt=[1], max_tokens=8)) == ("decode", 8)
    assert default_affinity(SimpleNamespace(prompt=[1], max_tokens=9)) == ("decode", 16)
    with pytest.raises(TypeError):
        default_affinity(object())


def test_entry_affinity_matches_submit_time_key():
    """A queued entry re-homes (on host leave) to the SAME key its request
    routed on."""
    gw, clock = _single()
    gw.submit(Request(budget=2, x0=_x0(0)))
    e = gw.queue.snapshot()[0]
    assert entry_affinity(e) == default_affinity(Request(budget=2, x0=_x0(0)))


# ---------------------------------------------------------------------------
# WorkStealer (pure planning)
# ---------------------------------------------------------------------------


def _loads(**depths):
    return {h: HostLoad(queue_depth=d, inflight=0) for h, d in depths.items()}


def test_stealer_pairs_idle_thieves_with_deepest_victims():
    s = WorkStealer(min_queue=2, max_steal=8, idle_depth=0)
    moves = s.plan(_loads(h0=12, h1=0, h2=0, h3=0))
    # each thief hits the then-deepest shard; amounts halve the victim
    assert moves == [("h0", "h1", 6), ("h0", "h2", 3), ("h0", "h3", 2)]


def test_stealer_respects_min_queue_and_max_steal():
    s = WorkStealer(min_queue=4, max_steal=2)
    assert s.plan(_loads(h0=3, h1=0)) == []                 # victim too shallow
    assert s.plan(_loads(h0=9, h1=0)) == [("h0", "h1", 2)]   # capped
    assert WorkStealer(max_steal=0).plan(_loads(h0=9, h1=0)) == []


def test_stealer_busy_hosts_are_not_thieves():
    s = WorkStealer()
    loads = {"h0": HostLoad(12, 0), "h1": HostLoad(0, 3), "h2": HostLoad(1, 0)}
    assert s.plan(loads) == []       # h1 has work in flight, h2 has a queue
    # explicit thieves override idleness detection
    assert s.plan(loads, thieves=["h2"]) == [("h0", "h2", 6)]


def test_stealer_is_deterministic():
    s = WorkStealer()
    loads = _loads(h0=7, h1=7, h2=0, h3=0)
    assert s.plan(loads) == s.plan(dict(reversed(list(loads.items()))))


def test_stealer_plans_equal_the_reference():
    """The reference's planner on the same load snapshots (urgent victims
    first, explicit thieves)."""
    from repro.serving.gateway import HostLoad as JaxHostLoad
    from repro.serving.fleet import WorkStealer as JaxWorkStealer

    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(2, 7))
        raw = [(int(rng.integers(0, 14)), int(rng.integers(0, 2)), int(rng.integers(0, 3)))
               for _ in range(n)]
        knobs = dict(min_queue=int(rng.integers(1, 4)), max_steal=int(rng.integers(0, 9)),
                     idle_depth=int(rng.integers(0, 2)))
        ours = WorkStealer(**knobs).plan(
            {f"h{i}": HostLoad(*r) for i, r in enumerate(raw)})
        ref = JaxWorkStealer(**knobs).plan(
            {f"h{i}": JaxHostLoad(*r) for i, r in enumerate(raw)})
        assert ours == ref


# ---------------------------------------------------------------------------
# FleetGateway: routing + bit-identity against the single-gateway oracle
# ---------------------------------------------------------------------------


def test_fleet_mixed_budget_trace_bit_identical_to_single_gateway():
    """A mixed-budget trace served by a 4-host fleet resolves every sample
    bit-identically to one Gateway serving the same trace."""
    fleet, fclock = _fleet(4)
    single, sclock = _single()
    reqs = [Request(budget=BUDGETS[i % 2], x0=_x0(i)) for i in range(24)]
    ff = [fleet.submit(r) for r in reqs]
    sf = [single.submit(r) for r in reqs]
    # affinity groups each budget on one host; both budget groups are live
    assert len({fleet.home(r) for r in reqs}) == 2
    fclock.advance(1.0)
    fleet.drain()
    _drain_fake(single, sclock)
    _bits(ff, sf)
    st = fleet.stats()
    assert st["submitted"] == st["completed"] == 24
    assert sum(st["routed"].values()) == 24


def test_fleet_folded_seed_path_bit_identical_to_single_gateway():
    """Requests without x0 draw noise from fold_in(base seed, uid): the
    fleet's shared uid counter and base seed make each request's seed
    exactly what a lone gateway would fold at the same submission index."""
    fleet, fclock = _fleet(3)
    single, sclock = _single()
    toks = torch.zeros((3,), dtype=torch.int32)
    reqs = [Request(tokens=toks, budget=BUDGETS[i % 2]) for i in range(12)]
    ff = [fleet.submit(r) for r in reqs]
    sf = [single.submit(r) for r in reqs]
    fclock.advance(1.0)
    fleet.drain()
    _drain_fake(single, sclock)
    _bits(ff, sf)


def test_fleet_base_seed_is_the_lone_gateways_seed():
    clock = FakeClock()
    fleet = FleetGateway({f"h{i}": Gateway(_sampler(), clock=clock, max_batch=8)
                          for i in range(2)}, base_seed=5, steal=False)
    single, sclock = _single(seed=5)
    toks = torch.zeros((3,), dtype=torch.int32)
    ff = [fleet.submit(tokens=toks, budget=2) for _ in range(3)]
    sf = [single.submit(tokens=toks, budget=2) for _ in range(3)]
    clock.advance(1.0)
    fleet.drain()
    _drain_fake(single, sclock)
    _bits(ff, sf)


def test_fleet_same_trace_same_seed_is_deterministic():
    """Two fresh fleets, same trace: identical host assignments AND
    identical sample bytes."""
    toks = torch.zeros((3,), dtype=torch.int32)

    def run():
        fleet, clock = _fleet(4)
        reqs = [Request(tokens=toks, budget=BUDGETS[i % 2]) for i in range(16)]
        homes = [fleet.home(r) for r in reqs]
        futs = [fleet.submit(r) for r in reqs]
        clock.advance(1.0)
        fleet.drain()
        return homes, [np.asarray(f.result().latents) for f in futs]

    homes_a, lat_a = run()
    homes_b, lat_b = run()
    assert homes_a == homes_b
    for a, b in zip(lat_a, lat_b):
        np.testing.assert_array_equal(a, b)


def test_fleet_submit_and_stats_plumbing():
    fleet, clock = _fleet(2)
    futs = [fleet.submit(budget=2, x0=_x0(i)) for i in range(3)]   # kwargs
    clock.advance(1.0)
    assert fleet.pump() > 0
    assert all(f.done() for f in futs)
    st = fleet.stats()
    assert st["hosts"] == 2 and st["completed"] == 3
    assert st["queue_depth"] == 0
    assert set(st["per_host"]) == {"h0", "h1"}
    assert 0.0 < st["occupancy"] <= 1.0
    fleet.shutdown()
    with pytest.raises(RuntimeError, match="draining"):
        fleet.submit(budget=2, x0=_x0(9))


def test_fleet_submit_stream_routes_and_terminates():
    fleet, clock = _fleet(2)
    stream = fleet.submit_stream(budget=4, x0=_x0(0))
    clock.advance(1.0)
    fleet.drain()
    chunks = stream.chunks(timeout=5)
    assert chunks[-1].final
    single, sclock = _single()
    alone = single.submit(budget=4, x0=_x0(0))
    _drain_fake(single, sclock)
    np.testing.assert_array_equal(chunks[-1].payload.latents, alone.result().latents)


@pytest.mark.parametrize("policy,budgets,n_hosts", [
    ("never", (2, 4), 4), ("auto", (2, 4), 3), ("always", (2, 4, 16), 2)])
def test_fleet_explicit_x0_matches_the_reference_fleet(policy, budgets, n_hosts):
    """The same explicit-x0 trace through the reference's fleet and the
    port's, on toy samplers sharing the reference's jittered solver: the
    same homes, the same serving metadata, latents within f32 2e-5."""
    ref_sampler = JaxCountingToy(budgets=budgets)
    theta = anytime_params_from_numpy(*(np.asarray(p) for p in ref_sampler.theta))
    kw = dict(max_batch=4, max_wait_ms=10.0, mixed_budget_policy=policy)
    jclock, tclock = JaxFakeClock(), FakeClock()
    jfleet = JaxFleetGateway({f"h{i}": JaxGateway(JaxCountingToy(budgets=budgets),
                                                  clock=jclock, **kw)
                              for i in range(n_hosts)},
                             stealer=WorkStealer(min_queue=2, max_steal=8))
    tfleet = FleetGateway({f"h{i}": Gateway(_sampler(budgets, theta), clock=tclock, **kw)
                           for i in range(n_hosts)},
                          stealer=WorkStealer(min_queue=2, max_steal=8))
    traffic = [(budgets[(i * 7) % len(budgets)], _x0(i)) for i in range(14)]
    jf = [jfleet.submit(JaxRequest(budget=b, x0=x0)) for b, x0 in traffic]
    tf = [tfleet.submit(Request(budget=b, x0=x0)) for b, x0 in traffic]
    assert [jfleet.home(JaxRequest(budget=b, x0=x0)) for b, x0 in traffic] == \
        [tfleet.home(Request(budget=b, x0=x0)) for b, x0 in traffic]
    assert jfleet.steal_round() == tfleet.steal_round()
    jclock.advance(1.0)
    tclock.advance(1.0)
    jfleet.drain()
    tfleet.drain()
    for j, t in zip(jf, tf):
        j, t = j.result(timeout=30), t.result(timeout=30)
        assert {k: t.meta[k] for k in ("requested_budget", "served_budget", "batch_real",
                                       "batch_padded", "mixed")} == \
            {k: j.meta[k] for k in ("requested_budget", "served_budget", "batch_real",
                                    "batch_padded", "mixed")}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents), atol=TOL, rtol=TOL)
    js, ts = jfleet.stats(), tfleet.stats()
    for key in ("routed", "queue_depths", "steals", "steal_rounds", "completed",
                "batches", "forwards"):
        assert ts[key] == js[key], key


# ---------------------------------------------------------------------------
# Work stealing end-to-end
# ---------------------------------------------------------------------------


def test_steal_rebalances_deep_shard_onto_idle_hosts():
    """One hot affinity key piles 12 requests on one shard; a steal round
    spreads them across the idle hosts — and every sample still matches the
    single-gateway oracle bit for bit."""
    fleet, fclock = _fleet(4, stealer=WorkStealer(min_queue=2, max_steal=8))
    single, sclock = _single()
    reqs = [Request(budget=2, x0=_x0(i)) for i in range(12)]
    home = fleet.home(reqs[0])
    ff = [fleet.submit(r) for r in reqs]
    sf = [single.submit(r) for r in reqs]
    assert fleet.stats()["queue_depths"][home] == 12
    moved = fleet.steal_round()
    assert moved == 11                    # 6 + 3 + 2 across the three thieves
    depths = fleet.stats()["queue_depths"]
    assert depths[home] == 1
    assert sorted(d for h, d in depths.items() if h != home) == [2, 3, 6]
    fclock.advance(1.0)
    fleet.drain()
    _drain_fake(single, sclock)
    _bits(ff, sf)
    st = fleet.stats()
    assert st["steals"] == 11 and st["steal_rounds"] == 1
    assert st["stolen_out"] == st["stolen_in"] == 11
    assert st["per_host"][home]["stolen_out"] == 11
    # one count per request fleet-wide, wherever entries migrated
    assert st["submitted"] == st["completed"] == 12


def test_steal_never_touches_inflight_entries():
    gw, clock = _single()
    gw.submit(Request(budget=2, x0=_x0(0)))
    gw.submit(Request(budget=2, x0=_x0(1)))
    taken = gw.queue.snapshot()[:1]
    gw._take(taken)                       # a planned batch in flight
    stolen = gw.steal(None)
    assert [e.uid for e in stolen] == [1]     # only the still-queued entry
    assert gw.load().inflight == 1
    gw._settle(1)                         # avoid wedging the toy gateway
    taken[0].future.set_result(None)


def test_steal_round_skips_when_balanced_or_disabled():
    fleet, clock = _fleet(2, steal=False)
    fleet.submit(budget=2, x0=_x0(0))
    assert fleet.steal_round() == 0           # stealer disabled
    fleet2, _ = _fleet(2, stealer=WorkStealer())
    fleet2.submit(budget=2, x0=_x0(0))
    assert fleet2.steal_round() == 0          # victim below min_queue


# ---------------------------------------------------------------------------
# Host join / leave
# ---------------------------------------------------------------------------


def test_join_and_leave_mid_traffic_no_dropped_futures():
    """Submit, grow the fleet, submit more, retire the busiest host: its
    queued shard re-homes to the survivors, every future resolves, and the
    samples still match the single-gateway oracle bit for bit."""
    fleet, fclock = _fleet(3)
    single, sclock = _single()
    reqs = [Request(budget=BUDGETS[i % 2], x0=_x0(i)) for i in range(18)]
    sf = [single.submit(r) for r in reqs]
    ff = [fleet.submit(r) for r in reqs[:9]]
    fleet.add_host("h3", Gateway(_sampler(), clock=fclock, max_batch=8, max_wait_ms=10.0,
                                 mixed_budget_policy="never"))
    assert fleet.hosts == ("h0", "h1", "h2", "h3")
    ff += [fleet.submit(r) for r in reqs[9:]]
    victim = fleet.home(Request(budget=2, x0=_x0(0)))
    queued = fleet.stats()["queue_depths"][victim]
    assert queued > 0
    fleet.remove_host(victim)
    assert victim not in fleet.hosts
    st = fleet.stats()
    assert st["rerouted"] == queued
    assert st["queue_depth"] == 18    # every queued entry is in a surviving shard
    # migrated budget-2 entries landed where new same-key submits now route
    new_home = fleet.home(Request(budget=2, x0=_x0(0)))
    assert st["queue_depths"][new_home] > 0
    fclock.advance(1.0)
    fleet.drain()
    _drain_fake(single, sclock)
    assert all(f.done() for f in ff)
    _bits(ff, sf)


def test_remove_host_bounded_drain_raises_on_wedged_engine():
    fleet, clock = _fleet(2)
    req = Request(budget=2, x0=_x0(0))
    home = fleet.home(req)
    fleet.submit(req)
    gw = fleet._hosts[home].gateway
    gw._take(gw.queue.snapshot())         # wedge: in flight, never resolving
    with pytest.raises(DrainTimeout) as err:
        fleet.remove_host(home, timeout=0.05)
    assert err.value.stats["queue_depth"] == 0
    assert "inflight=1" in str(err.value)
    assert home not in fleet.hosts        # routing left BEFORE the drain


def test_membership_validation():
    fleet, clock = _fleet(2)
    with pytest.raises(ValueError, match="already"):
        fleet.add_host("h0", Gateway(_sampler(), clock=clock))
    with pytest.raises(KeyError):
        fleet.remove_host("nope")
    fleet.remove_host("h1")
    with pytest.raises(RuntimeError, match="last host"):
        fleet.remove_host("h0")
    with pytest.raises(ValueError, match="at least one host"):
        FleetGateway({})


def test_threaded_fleet_serves_on_real_clock():
    """start() runs per-host serve threads and the balancer; futures resolve
    without manual pumping; shutdown drains everything."""
    hosts = {f"h{i}": Gateway(_sampler(), max_batch=4, max_wait_ms=5.0,
                              mixed_budget_policy="never")
             for i in range(2)}
    fleet = FleetGateway(hosts, stealer=WorkStealer(min_queue=1))
    fleet.start(poll_s=0.001, balance_s=0.001)
    futs = [fleet.submit(budget=BUDGETS[i % 2], x0=_x0(i)) for i in range(6)]
    for f in futs:
        assert f.result(timeout=30).latents.shape == (2,)
    fleet.shutdown(timeout=30)
    assert fleet.stats()["completed"] == 6


def test_fleet_metrics_snapshot_merges_hosts_and_fleet_counters():
    fleet, fclock = _fleet(4, stealer=WorkStealer(min_queue=2, max_steal=8))
    for i in range(6):
        fleet.submit(budget=2, x0=_x0(i))
    assert fleet.steal_round() > 0
    fclock.advance(1.0)
    fleet.drain()
    snap = fleet.metrics_snapshot()
    assert snap["completed"] == 6 and snap["steals"] == fleet.stats()["steals"]


def test_threaded_fleet_of_more_hosts_than_cores_keeps_every_row():
    """Stress: more serving threads than cores, a short switch interval, the
    balancer stealing all along. One dispatch runs at a time in the process
    (``gateway.EXEC_LOCK``: forward-mode AD levels are the process's), every
    future resolves, and every row equals a lone gateway's to the bit
    whatever batch it rode in."""
    import os
    import sys

    n_hosts = (os.cpu_count() or 4) + 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fleet = FleetGateway({f"h{i}": Gateway(_sampler(), max_batch=4, max_wait_ms=1.0,
                                               mixed_budget_policy="never")
                              for i in range(n_hosts)}, stealer=WorkStealer(min_queue=1))
        fleet.start(poll_s=0.0005, balance_s=0.0005)
        reqs = [Request(budget=BUDGETS[i % 2], x0=_x0(i)) for i in range(48)]
        futs = [fleet.submit(r) for r in reqs]
        results = [f.result(timeout=120) for f in futs]
        fleet.shutdown(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    single, sclock = _single()
    alone = [single.submit(r) for r in reqs]
    _drain_fake(single, sclock)
    for r, a in zip(results, alone):
        np.testing.assert_array_equal(r.latents, a.result().latents)
    assert fleet.stats()["completed"] == 48
