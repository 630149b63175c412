"""The serving engines' program cache (``repro_torch.serving.programs``) on the CPU.

The card captures CUDA graphs; here ``CPUGraph`` (``torch_graph_double.py``)
stands in for one through the module's test hook: a "capture" runs the
function once over the static buffers and puts back every state tensor it
wrote (a capture launches nothing), a "replay" runs it again into the same
output tensors. The
caches' keys, copies, counts and state handling are then the card's, and
their results are held against the eager engines (to the bit) and against
the reference's jitted programs on a shared x0 (``tests/test_kernels.py``'s
f32 2e-5, scaled by NFE as ``tests/test_torch_anytime.py`` scales it). The
program counts mirror the reference's jit caches (``_cache_size()``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.core.anytime import init_anytime as jax_init_anytime
from repro.models import model as jmodel
from repro.serving import AnytimeFlowSampler as JaxAnytimeSampler
from repro.serving import engine as jengine
from repro.solvers import SolverArtifact as JaxArtifact
from repro.solvers import SolverSpec as JaxSpec
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.core.anytime import init_anytime
from repro_torch.kernels import build
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import (
    AnytimeFlowSampler,
    DecodeEngine,
    FlowSampler,
    Gateway,
    Request,
    SamplingParams,
    programs,
)
from repro_torch.serving.engine import SlotSampling
from repro_torch.serving.toy import FakeClock
from repro_torch.solvers import SolverArtifact, SolverSpec
from repro_torch.solvers import registry as treg
from torch_graph_double import CPUGraph

BUDGETS = (2, 4)
TOL = 2e-5


@pytest.fixture
def graphs(monkeypatch):
    """Engines built inside the test capture and replay through ``CPUGraph``."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(4, 8)).astype(np.int32)
    return jcfg, jparams, cfg, params, tok


def _anytime(smoke):
    _, _, cfg, params, _ = smoke
    art = SolverArtifact(spec=SolverSpec("midpoint", mode="anytime", budgets=BUDGETS),
                         params=init_anytime(None, BUDGETS, "nested"), val_psnr=0.0)
    return AnytimeFlowSampler.from_artifact(art, params=params, cfg=cfg, sched=tsched.fm_ot())


def _reference_anytime(smoke):
    jcfg, jparams, _, _, _ = smoke
    jart = JaxArtifact(spec=JaxSpec("midpoint", mode="anytime", budgets=BUDGETS),
                       params=jax_init_anytime(None, BUDGETS, "nested"), val_psnr=0.0)
    return JaxAnytimeSampler.from_artifact(jart, params=jparams, cfg=jcfg,
                                           sched=jsched.fm_ot())


def _x0(seed, rows, cfg, seq=8):
    return np.random.default_rng(seed).standard_normal(
        (rows, seq, cfg.latent_dim)).astype(np.float32)


def _batch(tok):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tok))}


def test_the_cpu_runs_eagerly_without_the_double(smoke):
    """On the CPU (no card, no test double) nothing is captured."""
    _, _, cfg, _, tok = smoke
    sampler = _anytime(smoke)
    assert not sampler.programs.active
    sampler.sample_from(_batch(tok[:2]), _x0(1, 2, cfg), 2)
    assert len(sampler.programs) == 0


def test_one_program_per_budget_and_bucket_as_the_reference(smoke, graphs):
    """The twin of the reference's ``test_backbone_bucket_reuses_jit_program``:
    two same-bucket flushes at budget 2 and one at budget 4 are two programs,
    as the reference's jit caches hold two entries."""
    _, _, cfg, _, tok = smoke
    sampler, ref = _anytime(smoke), _reference_anytime(smoke)
    gw = Gateway(sampler, max_batch=4, max_wait_ms=10.0, clock=FakeClock())
    jb = {"tokens": jnp.asarray(tok)}
    for rnd, budget in enumerate((2, 2, 4)):
        x0 = _x0(rnd, 3, cfg)
        futs = [gw.submit(Request(tokens=tok[i], budget=budget, x0=x0[i])) for i in range(3)]
        gw.clock.advance(1.0)
        assert gw.pump() == 1
        for f in futs:
            f.result(timeout=5)
        ref.sample_from(jb, jnp.asarray(np.concatenate([x0, x0[:1]])), budget)
    assert len(sampler.programs) == 2
    assert ref._per_budget[2]._cache_size() == ref._per_budget[4]._cache_size() == 1
    s = gw.stats()
    assert (s["jit_programs"], s["program_captures"], s["program_replays"]) == (2, 2, 1)


def test_one_program_per_leg_as_the_reference(smoke, graphs):
    """Two trajectories of legs 0->2->4 are two programs (the reference's
    ``_extends`` holds the same two legs, one compiled shape each)."""
    _, _, cfg, _, tok = smoke
    sampler, ref = _anytime(smoke), _reference_anytime(smoke)
    b, jb = _batch(tok[:2]), {"tokens": jnp.asarray(tok[:2])}
    for seed in (3, 4):
        x0 = _x0(seed, 2, cfg)
        carry, jcarry = sampler.carry_start(b, x0), ref.carry_start(jb, jnp.asarray(x0))
        for stop in BUDGETS:
            carry, _ = sampler.carry_extend(b, carry, stop)
            jcarry, _ = ref.carry_extend(jb, jcarry, stop)
    assert len(sampler.programs) == 2
    assert sampler.programs.replays == 2
    assert sorted(ref._extends) == [(0, 2), (2, 4)]
    assert all(fn._cache_size() == 1 for fn in ref._extends.values())


def test_shape_conditioning_and_cfg_scale_get_their_own_programs(smoke, graphs):
    """A key holds the input shapes, conditioning or none, and the CFG scale:
    each new one captures, each repeat replays."""
    _, _, cfg, params, tok = smoke
    ns = treg.build_ns("euler", 2, None)
    sampler = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(), solver=ns)
    calls = [(_batch(tok[:2]), _x0(1, 2, cfg)), (_batch(tok[:3]), _x0(2, 3, cfg)),
             (None, _x0(3, 2, cfg)), (_batch(tok[:2, :6]), _x0(4, 2, cfg, seq=6))]
    for batch, x0 in calls + calls:
        sampler.sample_from(batch, x0)
    assert (len(sampler.programs), sampler.programs.replays) == (4, 4)
    sampler.cfg_scale = 0.5
    got = sampler.sample_from(*calls[0])
    assert len(sampler.programs) == 5
    with programs.disabled():
        assert torch.equal(got, sampler.sample_from(*calls[0]))


def test_a_returned_tensor_survives_the_next_replay(smoke, graphs):
    """Outputs are copies of the static outputs: the next replay of the same
    program does not touch what an earlier call returned."""
    _, _, cfg, _, tok = smoke
    sampler = _anytime(smoke)
    b = _batch(tok[:2])
    first = [sampler.sample_from(b, _x0(s, 2, cfg), 4) for s in (5, 6, 7)]
    kept = [x.clone() for x in first]
    sampler.sample_from(b, _x0(8, 2, cfg), 4)
    assert sampler.programs.replays == 3
    for x, k in zip(first, kept):
        assert torch.equal(x, k)
    assert not torch.equal(first[1], first[2])
    exits = [sampler.carry_extend(b, sampler.carry_start(b, _x0(s, 2, cfg)), 2)
             for s in (9, 10)]
    assert not torch.equal(exits[0][1][2], exits[1][1][2])
    assert not torch.equal(exits[0][0].U, exits[1][0].U)


def test_programs_equal_eager_and_the_reference(smoke, graphs):
    """Per-budget, shared-trajectory and per-leg programs, replayed: equal to
    the same calls under ``programs.disabled()`` to the bit, and to the
    reference's jitted programs on the same x0 within f32 2e-5 x NFE."""
    _, _, cfg, _, tok = smoke
    sampler, ref = _anytime(smoke), _reference_anytime(smoke)
    b, jb = _batch(tok[:2]), {"tokens": jnp.asarray(tok[:2])}
    x0 = _x0(11, 2, cfg)
    for _ in range(2):                      # capture, then replay
        got = {m: sampler.sample_from(b, x0, m) for m in BUDGETS}
        got_all = sampler.sample_all_from(b, x0)
        carry = sampler.carry_start(b, x0)
        legs = {}
        for stop in BUDGETS:
            carry, e = sampler.carry_extend(b, carry, stop)
            legs.update(e)
    assert sampler.programs.replays == 5
    with programs.disabled():
        eager = {m: sampler.sample_from(b, x0, m) for m in BUDGETS}
        eager_all = sampler.sample_all_from(b, x0)
        ecarry = sampler.carry_extend(b, sampler.carry_start(b, x0), 2)[0]
    jcarry, _ = ref.carry_extend(jb, ref.carry_start(jb, jnp.asarray(x0)), 2)
    want_all = ref.sample_all_from(jb, jnp.asarray(x0))
    for m in BUDGETS:
        for x in (got[m], got_all[m], legs[m]):
            assert torch.equal(x, eager[m])
            np.testing.assert_allclose(x.numpy(), np.asarray(ref.sample_from(
                jb, jnp.asarray(x0), m)), rtol=TOL * m, atol=TOL * m)
        assert torch.equal(got_all[m], eager_all[m])
        np.testing.assert_allclose(got_all[m].numpy(), np.asarray(want_all[m]),
                                   rtol=TOL * m, atol=TOL * m)
    leg = sampler.carry_extend(b, sampler.carry_start(b, x0), 2)[0]
    assert torch.equal(leg.U, ecarry.U) and torch.equal(leg.x, ecarry.x)
    np.testing.assert_allclose(leg.x.numpy(), np.asarray(jcarry.x), rtol=2 * TOL, atol=2 * TOL)


@pytest.fixture(scope="module")
def decode(smoke):
    jcfg, jparams, cfg, params, _ = smoke
    out = {}
    for name, kw in (("dense", {}), ("paged", dict(page_size=4, paged_kernel=True))):
        out[name] = (jengine.DecodeEngine(params=jparams, cfg=jcfg, **kw), (params, cfg, kw))
    return out


def _table(S, nb):
    return (np.arange(S * nb, dtype=np.int32) + 1).reshape(S, nb)


def _leaves(state):
    return [leaf.data_ptr() for leaf in state]


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_one_program_per_prefill_width_and_slots_as_the_reference(decode, name, graphs):
    """Prefill widths 4, 4, 2 and two steps on one slot state: one program a
    width and one step program; a state of other slots gets its own. The
    reference's ``_prefill_fns`` holds the same two widths."""
    jeng, (params, cfg, kw) = decode[name]
    teng = DecodeEngine(params=params, cfg=cfg, **kw)
    rng = np.random.default_rng(2)
    for S in (3, 2):
        tstate = teng.init_slot_state(S, 16)
        jstate = jeng.init_slot_state(S, 16)
        if name == "paged":
            tstate = teng.with_block_table(tstate, _table(S, 4))
            jstate = jeng.with_block_table(jstate, _table(S, 4))
        for C in (4, 4, 2):
            tok = rng.integers(0, cfg.vocab, size=(S, C)).astype(np.int32)
            lengths = np.full(S, C, np.int32)
            tstate = teng.prefill_slots(tok, lengths, tstate, np.ones(S, bool))
            jstate = jeng.prefill_slots(tok, lengths, jstate, np.ones(S, bool))
        for _ in range(2):
            tnext, tstate = teng.step_slots(tok[:, 0], tstate, np.ones(S, bool))
            jnext, jstate = jeng.step_slots(tok[:, 0], jstate, np.ones(S, bool))
            np.testing.assert_array_equal(np.asarray(tnext), np.asarray(jnext))
    assert len(teng.programs) == 2 * 3
    assert teng.programs.replays == 2 * 2
    assert sorted(jeng._prefill_fns) == [2, 4]


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_decode_programs_equal_eager_and_keep_the_state_leaves(decode, name, graphs):
    """prefill, greedy and sampled steps, reset and a new block table: every
    state leaf keeps its tensor (``data_ptr()``), the programs replay (no
    recapture), and tokens and state equal the eager engine's to the bit."""
    _, (params, cfg, kw) = decode[name]
    S, C = 3, 4
    engines = [DecodeEngine(params=params, cfg=cfg, **kw) for _ in range(2)]
    states = [e.init_slot_state(S, 16) for e in engines]
    sampling = SlotSampling(seeds=np.arange(S, dtype=np.uint64) + 7,
                            counts=np.zeros(S, np.int32),
                            temps=np.array([0.0, 0.8, 1.2], np.float32),
                            top_ks=np.array([0, 5, 0], np.int32),
                            top_ps=np.array([1.0, 1.0, 0.9], np.float32))
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, size=(S, C)).astype(np.int32)
    ptrs = _leaves(states[0])
    toks = [[], []]
    for i, (eng, state) in enumerate(zip(engines, states)):
        ctx = programs.disabled() if i else contextlib.nullcontext()
        with ctx:
            if name == "paged":
                state = eng.with_block_table(state, _table(S, 4))
            state = eng.prefill_slots(prompt, np.array([4, 3, 2], np.int32), state,
                                      np.ones(S, bool))
            feed = prompt[:, 0]
            for step in range(4):
                active = np.array([True, step % 2 == 0, True])
                samp = sampling._replace(counts=np.full(S, step, np.int32))
                feed, state = eng.step_slots(feed, state, active,
                                             sampling=samp if step % 2 else None)
                toks[i].append(np.asarray(feed))
            state = eng.reset_slots(state, np.array([False, True, False]))
            if name == "paged":
                state = eng.with_block_table(state, _table(S, 4)[::-1].copy())
            feed, state = eng.step_slots(feed, state, np.ones(S, bool))
            toks[i].append(np.asarray(feed))
        states[i] = state
    assert _leaves(states[0]) == ptrs
    assert (len(engines[0].programs), engines[0].programs.replays) == (3, 3)
    assert len(engines[1].programs) == 0
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_greedy_replays_one_step_program(smoke, graphs):
    """``greedy`` over n steps is one program, captured once and replayed
    n - 1 times (the reference jits one scan a step count), with the eager
    engine's tokens and cache."""
    _, _, cfg, params, _ = smoke
    got = []
    for ctx in (contextlib.nullcontext(), programs.disabled()):
        with ctx:
            eng = DecodeEngine(params=params, cfg=cfg)
            state = eng.init_state(2, 16)
            tokens, state = eng.greedy(np.array([3, 5], np.int32), state, 5)
            got.append((tokens, state, eng))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)
    assert int(got[0][1].index) == 5
    assert (len(got[0][2].programs), got[0][2].programs.replays) == (1, 4)


def test_launch_counts_sum_over_replays_and_equal_eager():
    """A capture launches nothing; each replay adds what its program recorded,
    so n calls count what n eager calls count."""
    counter = build.LaunchCounter("test_kernel")
    cache = programs.ProgramCache("cpu")

    def fn(x):
        counter.launches += 3
        return x * 2

    x = torch.arange(4.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(programs, "_graph_double", CPUGraph)
        for i in range(4):
            assert torch.equal(cache(("f",), fn, (x + i,)), (x + i) * 2)
        assert counter.launches == 12
        assert (len(cache), cache.replays) == (1, 3)
        assert list(cache.programs.values())[0].launches == {counter: 3}
        with programs.disabled():
            cache(("f",), fn, (x,))
        assert counter.launches == 15 and cache.replays == 3


def test_disabled_nests_and_restores():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(programs, "_graph_double", CPUGraph)
        cache = programs.ProgramCache("cpu")
        assert cache.active
        with programs.disabled():
            with programs.disabled():
                assert not cache.active
            assert not cache.active
        assert cache.active


def test_a_failed_capture_raises():
    """No eager fallback: an error while capturing reaches the caller and
    leaves no program behind."""
    class Broken(CPUGraph):
        def capture(self, run, state):
            raise RuntimeError("capture failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(programs, "_graph_double", Broken)
        cache = programs.ProgramCache("cpu")
        with pytest.raises(RuntimeError, match="capture failed"):
            cache(("f",), lambda x: x + 1, (torch.zeros(2),))
        assert len(cache) == 0


def test_sampling_params_route_to_the_sampled_program(smoke, graphs):
    """Greedy and sampled steps are two programs on one state."""
    _, _, cfg, params, _ = smoke
    eng = DecodeEngine(params=params, cfg=cfg)
    state = eng.init_slot_state(2, 8)
    sp = SamplingParams(temperature=0.7)
    samp = SlotSampling(seeds=np.array([1, 2], np.uint64), counts=np.zeros(2, np.int32),
                        temps=np.full(2, sp.temperature, np.float32),
                        top_ks=np.zeros(2, np.int32), top_ps=np.ones(2, np.float32))
    for sampling in (None, samp, None, samp):
        _, state = eng.step_slots(np.array([1, 2], np.int32), state, np.ones(2, bool),
                                  sampling=sampling)
    assert (len(eng.programs), eng.programs.replays) == (2, 2)
    assert state.index.tolist() == [4, 4]


def test_block_table_of_another_shape_is_refused(decode):
    _, (params, cfg, kw) = decode["paged"]
    eng = DecodeEngine(params=params, cfg=cfg, **kw)
    state = eng.init_slot_state(2, 16)
    with pytest.raises(ValueError, match="block table of shape"):
        eng.with_block_table(state, _table(2, 3))
