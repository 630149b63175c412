"""The port's decode gateway: greedy tokens served against the JAX
reference's ``DecodeGateway`` for the same request lists, and the port's own
twins of ``tests/test_paged_decode.py`` and ``tests/test_decode_gateway.py``
(over the port's ``ToyDecodeEngine`` where those use the reference's, and
over the port's ``DecodeEngine`` where they use the reference's engine).

yi-6b's smoke config, f32, the reference's params through
``params_from_jax``. Served tokens are compared exactly: both sides take an
argmax of logits that agree to f32 rounding (tests/test_torch_decode.py),
and the request lists here leave no near-tie.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.serving import decode as jdecode
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.decode import DecodeGateway, DecodeRequest, PageAllocator
from repro_torch.serving.engine import DecodeEngine, SamplingParams
from repro_torch.serving.toy import FakeClock, ToyDecodeEngine


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def engines(models):
    jcfg, jparams, cfg, params = models
    out = {}
    for name, kw in (("dense", {}), ("paged", dict(page_size=4, paged_kernel=True))):
        out[name] = (jengine.DecodeEngine(params=jparams, cfg=jcfg, **kw),
                     DecodeEngine(params=params, cfg=cfg, **kw))
    return out


def _drive(gw, futures):
    while not all(f.done() for f in futures):
        gw.pump()


def _serve(gw, reqs):
    futures = [gw.submit(r) for r in reqs]
    _drive(gw, futures)
    return [f.result().tokens.tolist() for f in futures]


def _solo_tokens(engine, prompt, n):
    """Teacher-force ``prompt`` through the plain scalar-index decode path,
    then greedy — independent of slots, pages and prefill."""
    state = engine.init_state(1, 32)
    for tok in prompt[:-1]:
        _, state = engine.step(torch.tensor([tok]), state)
    toks, _ = engine.greedy(torch.tensor([prompt[-1]]), state, n)
    return toks[0].tolist()


_STAT_KEYS = ("completed", "forwards", "batches", "prefill_calls", "prefill_tokens",
              "joins", "trajectories", "tokens_out", "slot_occupancy")


@pytest.mark.parametrize("prefill_chunk", [0, 4])
@pytest.mark.parametrize("name", ["dense", "paged"])
def test_served_tokens_match_the_reference_gateway(engines, name, prefill_chunk):
    """The same mixed request list (prompts of 1 to 6 tokens, mixed lengths,
    slot refill) through both gateways: the same tokens, finish reasons,
    slots and join steps, and the same forwards, prefill and refill counts."""
    jeng, teng = engines[name]
    spec = [([3, 7], 5), ([5], 3), ([9, 1, 4, 4, 2, 8], 4), ([2, 2], 6), ([11, 13, 6], 2)]
    kw = dict(max_slots=2, cache_slots=16, prefill_chunk=prefill_chunk)
    jgw = jdecode.DecodeGateway(jeng, **kw)
    tgw = DecodeGateway(teng, **kw)
    jfut = [jgw.submit(jdecode.DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    tfut = [tgw.submit(DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    _drive(jgw, jfut)
    _drive(tgw, tfut)
    for jf, tf in zip(jfut, tfut):
        assert tf.result().tokens.tolist() == jf.result().tokens.tolist()
        for key in ("finish_reason", "prompt_len", "new_tokens", "steps", "slot",
                    "join_step"):
            assert tf.result().meta[key] == jf.result().meta[key], key
    js, ts = jgw.stats(), tgw.stats()
    assert {k: ts[k] for k in _STAT_KEYS} == {k: js[k] for k in _STAT_KEYS}
    if name == "paged":
        assert (ts["pages_in_use"], ts["peak_pages"]) == (0, js["peak_pages"])


def test_sampled_request_matches_its_own_solo_run_not_the_references(engines):
    """A sampled request's tokens depend on (base seed, uid, step) only: the
    same request alone and beside other traffic gives the same tokens, and
    greedy neighbours stay equal to their solo decode. (Torch cannot draw
    JAX's threefry bits, so this holds within the port.)"""
    _, teng = engines["dense"]
    sp = SamplingParams(temperature=0.8, top_k=5)
    alone = _serve(DecodeGateway(teng, max_slots=2, cache_slots=16, seed=7),
                   [DecodeRequest(prompt=[3, 7], max_tokens=6, sampling=sp)])[0]
    toks = _serve(DecodeGateway(teng, max_slots=2, cache_slots=16, seed=7), [
        DecodeRequest(prompt=[3, 7], max_tokens=6, sampling=sp),    # uid 0
        DecodeRequest(prompt=[5, 2], max_tokens=6),
        DecodeRequest(prompt=[9], max_tokens=4),
    ])
    assert toks[0] == alone
    assert toks[1] == _solo_tokens(teng, [5, 2], 6)
    assert toks[2] == _solo_tokens(teng, [9], 4)
    other = _serve(DecodeGateway(teng, max_slots=2, cache_slots=16, seed=8),
                   [DecodeRequest(prompt=[3, 7], max_tokens=6, sampling=sp)])[0]
    assert other != alone
    assert all(0 <= t < teng.cfg.vocab for t in alone + other)


# -- paged KV cache (twins of tests/test_paged_decode.py) --------------------


def test_paged_gateway_bit_identical_to_dense(engines):
    reqs = [DecodeRequest(prompt=[i + 1, i + 2], max_tokens=t)
            for i, t in enumerate([3, 9, 5, 2, 7])]
    dense = DecodeGateway(engines["dense"][1], max_slots=2, cache_slots=16)
    paged_eng = engines["paged"][1]
    paged = DecodeGateway(paged_eng, max_slots=2, cache_slots=16)
    assert _serve(paged, reqs) == _serve(dense, reqs)
    s = paged.stats()
    assert s["joins"] > 0 and s["peak_pages"] > 0
    assert s["pages_in_use"] == 0 and s["peak_kv_per_slot"] <= 16


def test_paged_kernel_path_bit_identical_to_dense_gather(models):
    _, _, cfg, params = models
    reqs = [DecodeRequest(prompt=[3, 7], max_tokens=3), DecodeRequest(prompt=[5], max_tokens=2)]
    gather = DecodeGateway(DecodeEngine(params=params, cfg=cfg, page_size=4),
                           max_slots=2, cache_slots=8)
    kernel = DecodeGateway(DecodeEngine(params=params, cfg=cfg, page_size=4,
                                        paged_kernel=True), max_slots=2, cache_slots=8)
    assert _serve(kernel, reqs) == _serve(gather, reqs)


def test_page_allocator_accounting():
    alloc = PageAllocator(5)                # pages 1..4 usable, 0 = trash
    assert alloc.available == 4 and alloc.in_use == 0
    a = alloc.alloc(3)
    assert 0 not in a and len(set(a)) == 3
    assert alloc.in_use == 3 and alloc.peak == 3
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(2)
    alloc.free(a[:2])
    assert alloc.available == 3 and alloc.peak == 3   # high-water sticks
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_paged_head_of_line_blocking_keeps_fifo():
    eng = ToyDecodeEngine(page_size=4)
    # 4 usable pages; each request needs ceil((1+8-1)/4) = 2
    gw = DecodeGateway(eng, max_slots=3, cache_slots=8, total_pages=5)
    reqs = [DecodeRequest(prompt=[i + 1], max_tokens=8) for i in range(3)]
    futures = [gw.submit(r) for r in reqs]
    gw.pump()
    assert [s is not None for s in gw._slots] == [True, True, False]
    _drive(gw, futures)
    assert futures[2].result().meta["join_step"] > 0
    for r, f in zip(reqs, futures):
        assert f.result().tokens.tolist() == eng.solo_tokens(r.prompt, r.max_tokens)
    assert gw.stats()["pages_in_use"] == 0


# -- chunked batched prefill -------------------------------------------------


def test_chunked_prefill_tokens_identical_fewer_forwards(engines):
    _, eng = engines["dense"]
    prompt = [(3 * i + 1) % eng.cfg.vocab for i in range(9)]
    reqs = [DecodeRequest(prompt=prompt, max_tokens=4),
            DecodeRequest(prompt=prompt[:5], max_tokens=3)]
    legacy = DecodeGateway(eng, max_slots=2, cache_slots=16, prefill_chunk=0)
    chunked = DecodeGateway(eng, max_slots=2, cache_slots=16, prefill_chunk=4)
    chunked_toks = _serve(chunked, reqs)
    assert chunked_toks == _serve(legacy, reqs)
    assert chunked_toks[0] == _solo_tokens(eng, prompt, 4)
    sc, sl = chunked.stats(), legacy.stats()
    assert sc["forwards"] < sl["forwards"] and sc["prefill_calls"] > 0
    assert sc["prefill_tokens"] == (len(prompt) - 1) + (5 - 1)
    assert sl["prefill_calls"] == 0


def test_chunked_prefill_interleaves_with_decode():
    eng = ToyDecodeEngine()
    gw = DecodeGateway(eng, max_slots=2, cache_slots=64, prefill_chunk=4)
    f1 = gw.submit(DecodeRequest(prompt=[3], max_tokens=12))
    gw.pump()
    emitted_before = len(gw._slots[0].emitted)
    long_prompt = list(range(1, 18))
    f2 = gw.submit(DecodeRequest(prompt=long_prompt, max_tokens=2))
    gw.pump()                               # prefill call + decode step
    assert len(gw._slots[0].emitted) == emitted_before + 1
    _drive(gw, [f1, f2])
    assert f1.result().tokens.tolist() == eng.solo_tokens([3], 12)
    assert f2.result().tokens.tolist() == eng.solo_tokens(long_prompt, 2)


# -- the gateway over the toy engine (twins of tests/test_decode_gateway.py) --


def test_mixed_lengths_match_solo_oracle_with_refill():
    eng = ToyDecodeEngine()
    gw = DecodeGateway(eng, max_slots=2, cache_slots=16)
    reqs = [DecodeRequest(prompt=[i + 1, i + 2], max_tokens=t)
            for i, t in enumerate([3, 9, 5, 2, 7])]
    futures = [gw.submit(r) for r in reqs]
    _drive(gw, futures)
    for r, f in zip(reqs, futures):
        assert f.result().tokens.tolist() == eng.solo_tokens(r.prompt, r.max_tokens)
    s = gw.stats()
    assert s["completed"] == len(reqs) and s["joins"] > 0


def test_wall_step_accounting_and_refill_beats_run_to_completion():
    eng = ToyDecodeEngine()
    gw = DecodeGateway(eng, max_slots=4, cache_slots=16)
    futures = [gw.submit(DecodeRequest(prompt=[i + 1, i + 2], max_tokens=6))
               for i in range(4)]
    _drive(gw, futures)
    assert gw.stats()["forwards"] == 1 + 6 and eng.steps == 7      # (P-1) + T
    reqs = [([1 + i], t) for i, t in enumerate([16, 2, 2, 2] * 4)]

    def total_steps(refill):
        g = DecodeGateway(ToyDecodeEngine(), max_slots=4, cache_slots=16, refill=refill)
        fs = [g.submit(DecodeRequest(prompt=p, max_tokens=t)) for p, t in reqs]
        _drive(g, fs)
        return g.stats()["forwards"], [f.result().tokens.tolist() for f in fs]

    (cont, cont_toks), (rtc, rtc_toks) = total_steps(True), total_steps(False)
    assert cont_toks == rtc_toks and cont < rtc


def test_stop_token_per_slot():
    eng = ToyDecodeEngine()
    ref = eng.solo_tokens([5], 10)
    gw = DecodeGateway(eng, max_slots=2, cache_slots=16)
    f_stop = gw.submit(DecodeRequest(prompt=[5], max_tokens=10, stop_token=ref[3]))
    f_len = gw.submit(DecodeRequest(prompt=[5], max_tokens=10))
    _drive(gw, [f_stop, f_len])
    assert f_stop.result().tokens.tolist() == ref[:3]
    assert f_stop.result().meta["finish_reason"] == "stop"
    assert f_len.result().tokens.tolist() == ref
    assert f_len.result().meta["finish_reason"] == "length"


def test_wait_ends_at_admission():
    clock = FakeClock()
    eng = ToyDecodeEngine(on_step=lambda: clock.advance(0.001))
    gw = DecodeGateway(eng, max_slots=1, cache_slots=16, clock=clock)
    f1 = gw.submit(DecodeRequest(prompt=[3], max_tokens=4))
    f2 = gw.submit(DecodeRequest(prompt=[9], max_tokens=2))
    _drive(gw, [f1, f2])
    assert f1.result().meta["wait_ms"] == 0.0
    assert f2.result().meta["wait_ms"] == pytest.approx(4.0)
    assert gw.stats()["max_wait_ms"] == pytest.approx(4.0)


def test_cancelled_resident_sequence_frees_slot_next_pump():
    eng = ToyDecodeEngine()
    gw = DecodeGateway(eng, max_slots=1, cache_slots=64)
    f1 = gw.submit(DecodeRequest(prompt=[3], max_tokens=1000))
    f2 = gw.submit(DecodeRequest(prompt=[7], max_tokens=3))
    gw.pump()
    assert gw._slots[0] is not None and not f1.done()
    assert f1.cancel()
    gw.pump()
    _drive(gw, [f2])
    assert f2.result().tokens.tolist() == eng.solo_tokens([7], 3)
    s = gw.stats()
    assert s["cancelled"] == 1 and s["completed"] == 1 and s["tokens_out"] == 3
    assert gw._drained()


def test_cancelled_queued_sequence_never_admitted():
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=1, cache_slots=16)
    f1 = gw.submit(DecodeRequest(prompt=[3], max_tokens=2))
    f2 = gw.submit(DecodeRequest(prompt=[5], max_tokens=2))
    assert f2.cancel()
    _drive(gw, [f1])
    while not gw._drained():
        gw.pump()
    s = gw.stats()
    assert s["cancelled"] == 1 and s["completed"] == 1
    assert all(sl is None for sl in gw._slots)


def test_stats_tokens_per_s_zero_on_frozen_clock():
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=1, cache_slots=16, clock=FakeClock())
    f = gw.submit(DecodeRequest(prompt=[3], max_tokens=4))
    _drive(gw, [f])
    s = gw.stats()
    assert s["tokens_out"] == 4 and s["tokens_per_s"] == 0.0


def test_greedy_only_engine_rejects_sampling():
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=1, cache_slots=4)
    with pytest.raises(ValueError, match="does not support sampling"):
        gw.submit(DecodeRequest(prompt=[3], max_tokens=2,
                                sampling=SamplingParams(temperature=1.0)))
    f = gw.submit(DecodeRequest(prompt=[3], max_tokens=2,
                                sampling=SamplingParams(temperature=0.0)))
    _drive(gw, [f])
    assert f.result().tokens.tolist() == ToyDecodeEngine().solo_tokens([3], 2)


def test_validation_capacity_and_mesh(engines):
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=1, cache_slots=4)
    with pytest.raises(ValueError):
        gw.submit(DecodeRequest(prompt=[], max_tokens=4))
    with pytest.raises(ValueError):
        gw.submit(DecodeRequest(prompt=[3], max_tokens=0))
    with pytest.raises(ValueError):
        DecodeGateway(ToyDecodeEngine(), max_slots=0, cache_slots=4)
    with pytest.raises(TypeError, match="takes a torch DeviceMesh"):
        DecodeGateway(ToyDecodeEngine(), max_slots=1, cache_slots=4, mesh=object())
    _, eng = engines["dense"]
    real = DecodeGateway(eng, max_slots=2, cache_slots=8)
    with pytest.raises(ValueError, match="cache capacity"):
        real.submit(DecodeRequest(prompt=[3, 7], max_tokens=8))
    f = real.submit(DecodeRequest(prompt=[3, 7], max_tokens=7))   # exactly at capacity
    _drive(real, [f])
    assert f.result().tokens.tolist() == _solo_tokens(eng, [3, 7], 7)


def test_engine_failure_reaches_futures():
    class BoomEngine(ToyDecodeEngine):
        def step_slots(self, token, state, active):
            raise RuntimeError("boom")

    gw = DecodeGateway(BoomEngine(), max_slots=2, cache_slots=4)
    f = gw.submit(DecodeRequest(prompt=[3], max_tokens=4))
    assert gw.pump() == 1
    with pytest.raises(RuntimeError, match="boom"):
        f.result(timeout=1)
    assert gw.stats()["failed"] == 1 and gw._drained()
    assert all(s is None for s in gw._slots)


def test_real_engine_threaded_serving_and_drain(engines):
    """The serve thread over the port's engine: a sequence admitted into a
    freed slot decodes as the scalar-index path does; drain resolves all."""
    _, eng = engines["paged"]
    gw = DecodeGateway(eng, max_slots=2, cache_slots=32)
    gw.start()
    lengths = (4, 6, 3)
    futures = [gw.submit(DecodeRequest(prompt=[3, 7], max_tokens=t)) for t in lengths]
    gw.shutdown()
    ref = _solo_tokens(engines["dense"][1], [3, 7], max(lengths))
    for t, f in zip(lengths, futures):
        assert f.result().tokens.tolist() == ref[:t]
    s = gw.stats()
    assert s["completed"] == 3 and s["joins"] >= 1 and s["pages_in_use"] == 0
    with pytest.raises(RuntimeError):
        gw.submit(DecodeRequest(prompt=[1], max_tokens=1))


def test_drain_waits_for_inflight_slots():
    release = threading.Event()

    class SlowEngine(ToyDecodeEngine):
        def step_slots(self, token, state, active):
            release.wait(timeout=5)
            return super().step_slots(token, state, active)

    gw = DecodeGateway(SlowEngine(), max_slots=2, cache_slots=8)
    gw.start()
    f = gw.submit(DecodeRequest(prompt=[3], max_tokens=2))
    for _ in range(1000):
        if gw.queue.depth() == 0 and any(s is not None for s in gw._slots):
            break
        time.sleep(0.001)
    t = threading.Thread(target=gw.shutdown)
    t.start()
    assert not f.done()
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert f.done() and f.result().meta["finish_reason"] == "length"


def test_streamed_tokens_equal_the_response():
    gw = DecodeGateway(ToyDecodeEngine(), max_slots=2, cache_slots=16)
    stream = gw.submit_stream(prompt=[4, 2], max_tokens=5)
    while not stream.future.done():
        gw.pump()
    chunks = stream.chunks(timeout=5)
    assert [c.payload for c in chunks[:-1]] == chunks[-1].payload.tokens.tolist()
    assert chunks[-1].final and len(chunks) == 6
