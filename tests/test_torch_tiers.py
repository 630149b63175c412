"""The port's shape-tier ladder against the JAX reference, on the CPU.

Every case of ``tests/test_tiers.py`` is mirrored on the port's toy sampler,
fleet affinity included (the ladder's ``request_key``, which the fleet
router hashes, is also held against the reference's here). Beyond the reference's suite: tier padding on a 2-layer causal
backbone (yi-6b's smoke config, f32), where cropped rows equal the direct
sampler at the native shape to the bit, and the same tiered traffic through
the reference's gateway and the port's (f32 2e-5, equal metadata).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import ContinuousGateway as JaxContinuousGateway
from repro.serving import Gateway as JaxGateway
from repro.serving import Request as JaxRequest
from repro.serving.tiers import ShapeLadder as JaxShapeLadder
from repro.serving.toy import FakeClock as JaxFakeClock
from repro.serving.toy import ToyAnytimeSampler as JaxToySampler
from repro_torch.core.anytime import anytime_params_from_numpy
from repro_torch.serving import ContinuousGateway, Gateway, Request
from repro_torch.serving.tiers import ShapeLadder, TierOversize, crop_row, pad_rows
from repro_torch.serving.toy import FakeClock, ToyAnytimeSampler

LADDER = ShapeLadder((8, 16))
TOL = 2e-5


def _sampler():
    return ToyAnytimeSampler()


def _flush(tiers=LADDER, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 5.0)
    return Gateway(_sampler(), clock=FakeClock(), tiers=tiers, **kw)


def _continuous(tiers=LADDER, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_wait_ms", 5.0)
    return ContinuousGateway(_sampler(), clock=FakeClock(), tiers=tiers, **kw)


def _x0(i, rows):
    return np.random.default_rng(300 + i).standard_normal((rows, 2)).astype(np.float32)


def _direct(x0, budget):
    """The bit-identity oracle: a FRESH sampler at the NATIVE shape."""
    return _sampler().sample_from(None, x0[None], budget)[0].numpy()


# ---------------------------------------------------------------------------
# ladder mapping / parsing (pure)
# ---------------------------------------------------------------------------


def test_rung_maps_to_smallest_holding_rung():
    assert [LADDER.rung(n) for n in (1, 7, 8, 9, 16)] == [8, 8, 8, 16, 16]


def test_rung_oversize_raises_with_configured_rungs():
    with pytest.raises(TierOversize) as ei:
        LADDER.rung(17)
    assert ei.value.length == 17
    assert ei.value.rungs == (8, 16)
    assert "--tiers" in str(ei.value)


def test_parse_sorts_dedups_and_validates():
    assert ShapeLadder.parse("8,16").rungs == (8, 16)
    assert ShapeLadder.parse("16,8,8").rungs == (8, 16)
    with pytest.raises(ValueError):
        ShapeLadder.parse("8,sixteen")
    with pytest.raises(ValueError):
        ShapeLadder(())
    with pytest.raises(ValueError):
        ShapeLadder((0, 8))


def test_no_position_axis_is_its_own_exact_tier():
    assert LADDER.rung_for((5,)) is None
    assert LADDER.tier_shape((5,)) == (5,)
    assert LADDER.tier_shape((5, 2)) == (8, 2)
    assert LADDER.tier_shape((16, 2)) == (16, 2)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_rows_zero_fills_and_crop_row_roundtrips(as_tensor):
    arr = np.arange(10.0).reshape(5, 2)
    if as_tensor:
        arr = torch.from_numpy(arr)
    padded = pad_rows(arr, 8)
    assert tuple(padded.shape) == (8, 2) and type(padded) is type(arr)
    np.testing.assert_array_equal(np.asarray(padded[:5]), np.asarray(arr))
    np.testing.assert_array_equal(np.asarray(padded[5:]), 0.0)
    np.testing.assert_array_equal(np.asarray(crop_row(padded, (5, 2))), np.asarray(arr))
    assert pad_rows(arr, 5) is arr
    assert crop_row(arr, (5, 2)) is arr
    assert crop_row(arr, None) is arr


@pytest.mark.parametrize("tok,x0", [
    (None, (5, 2)), (None, (13, 2)), ((7,), None), ((7,), (7, 64)), (None, (5,)),
    ((3,), (17, 2)), (None, None),
])
def test_request_key_matches_the_reference(tok, x0):
    assert LADDER.request_key(tok, x0) == JaxShapeLadder((8, 16)).request_key(tok, x0)
    assert ShapeLadder.label((16, 2)) == JaxShapeLadder.label((16, 2)) == "16x2"


# ---------------------------------------------------------------------------
# gateway integration (flush + continuous)
# ---------------------------------------------------------------------------


def test_flush_bit_identity_at_every_rung():
    gw = _flush()
    lengths = (5, 8, 13, 16)
    x0s = [_x0(i, n) for i, n in enumerate(lengths)]
    futs = [gw.submit(Request(budget=4, x0=x)) for x in x0s]
    gw.drain()
    for fut, x0, n in zip(futs, x0s, lengths):
        resp = fut.result(timeout=5)
        assert resp.latents.shape == (n, 2)
        np.testing.assert_array_equal(resp.latents, _direct(x0, 4))
        assert resp.meta["native_shape"] == (n, 2)
        assert resp.meta["tier_shape"] == (LADDER.rung(n), 2)


def test_continuous_bit_identity_and_shared_trajectory_across_tiers():
    gw = _continuous(max_slots=3)
    lengths = (5, 7, 8)
    x0s = [_x0(10 + i, n) for i, n in enumerate(lengths)]
    futs = [gw.submit(Request(budget=8, x0=x)) for x in x0s]
    gw.drain()
    assert gw.stats()["trajectories"] == 1
    for fut, x0, n in zip(futs, x0s, lengths):
        got = fut.result(timeout=5).latents
        assert got.shape == (n, 2)
        np.testing.assert_array_equal(got, _direct(x0, 8))


def test_oversize_rejected_at_submit_without_side_effects():
    gw = _flush()
    with pytest.raises(TierOversize):
        gw.submit(Request(budget=4, x0=_x0(20, 17)))
    assert gw.queue.depth() == 0
    assert gw.stats()["submitted"] == 0


def test_untiered_gateway_keeps_exact_shapes():
    gw = _flush(tiers=None)
    futs = [gw.submit(Request(budget=4, x0=_x0(30 + i, n))) for i, n in enumerate((5, 7))]
    gw.drain()
    for fut, n in zip(futs, (5, 7)):
        resp = fut.result(timeout=5)
        assert resp.latents.shape == (n, 2)
        assert "tier_shape" not in resp.meta
    assert gw.stats()["batches"] == 2


def test_tier_occupancy_counters_and_gauge():
    gw = _flush(max_batch=2)
    for i, n in enumerate((5, 7)):
        gw.submit(Request(budget=4, x0=_x0(40 + i, n)))
    gw.drain()
    snap = gw.metrics.snapshot()
    label = 'tier="8x2"'
    assert snap[f"tier_real_rows{{{label}}}"] == 12
    assert snap[f"tier_padded_rows{{{label}}}"] == 16
    assert snap[f"tier_occupancy{{{label}}}"] == pytest.approx(0.75)


def test_mixed_tier_drain_under_cancellation():
    gw = _continuous(max_slots=3)
    x0s = [_x0(50 + i, n) for i, n in enumerate((5, 7, 8))]
    futs = [gw.submit(Request(budget=8, x0=x)) for x in x0s]
    futs[1].cancel()
    gw.drain()
    assert gw.queue.depth() == 0 and gw._traj is None
    for idx in (0, 2):
        got = futs[idx].result(timeout=5).latents
        assert got.shape == x0s[idx].shape
        np.testing.assert_array_equal(got, _direct(x0s[idx], 8))


# ---------------------------------------------------------------------------
# A causal backbone, and parity with the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone():
    from repro_torch.configs import get_config
    from repro_torch.core import schedulers as tsched
    from repro_torch.core.anytime import init_anytime
    from repro_torch.models import model as M
    from repro_torch.serving import AnytimeFlowSampler

    cfg = get_config("yi-6b", smoke=True)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, AnytimeFlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                                   anytime=init_anytime(None, (2, 4)), budgets=(2, 4))


@pytest.mark.parametrize("continuous", [False, True])
def test_backbone_tier_padding_bit_identical_at_the_native_shape(backbone, continuous):
    """yi-6b's flow field is causal: requests of 5 and 6 positions padded to
    rung 8 (tokens and noise) crop back to the direct sampler's rows at the
    native shape, to the bit."""
    cfg, sampler = backbone
    kw = dict(max_slots=2) if continuous else dict(max_batch=2)
    gw = (ContinuousGateway if continuous else Gateway)(
        sampler, clock=FakeClock(), tiers=ShapeLadder((8,)), max_wait_ms=5.0, **kw)
    rng = np.random.default_rng(4)
    reqs = [(n, rng.integers(0, cfg.vocab, (n,)),
             rng.standard_normal((n, cfg.latent_dim)).astype(np.float32)) for n in (5, 6)]
    futs = [gw.submit(Request(tokens=t, x0=x, budget=4)) for _, t, x in reqs]
    gw.drain()
    assert gw.stats()["batches" if not continuous else "trajectories"] == 1
    for fut, (n, t, x) in zip(futs, reqs):
        resp = fut.result(timeout=5)
        assert resp.meta["tier_shape"] == (8, cfg.latent_dim)
        direct = sampler.sample_from({"tokens": torch.from_numpy(t[None])}, x[None], 4)
        np.testing.assert_array_equal(resp.latents, direct[0].numpy())


@pytest.mark.parametrize("continuous", [False, True])
def test_tiered_traffic_matches_the_reference(continuous):
    ref = JaxToySampler(jit=False)
    port = ToyAnytimeSampler(theta=anytime_params_from_numpy(
        *(np.asarray(p) for p in ref.theta)))
    lengths = (5, 7, 13, 8, 16)
    x0s = [_x0(60 + i, n) for i, n in enumerate(lengths)]
    out = []
    for gw_cls, req_cls, clock, sampler, ladder in (
            ((JaxContinuousGateway if continuous else JaxGateway), JaxRequest,
             JaxFakeClock(), ref, JaxShapeLadder((8, 16))),
            ((ContinuousGateway if continuous else Gateway), Request, FakeClock(), port,
             LADDER)):
        kw = dict(max_slots=3) if continuous else dict(max_batch=2)
        gw = gw_cls(sampler, clock=clock, tiers=ladder, max_wait_ms=5.0, **kw)
        futs = [gw.submit(req_cls(budget=b, x0=jnp.asarray(x) if sampler is ref else x))
                for b, x in zip((4, 8, 16, 8, 4), x0s)]
        gw.drain()
        out.append(([f.result(timeout=30) for f in futs], gw.stats(),
                     gw.metrics.snapshot()))
    (jres, jstats, jsnap), (tres, tstats, tsnap) = out
    for j, t in zip(jres, tres):
        assert t.meta == {k: v for k, v in j.meta.items() if k != "wait_ms"} | {
            "wait_ms": t.meta["wait_ms"]}
        np.testing.assert_allclose(t.latents, np.asarray(j.latents), atol=TOL, rtol=TOL)
    for key in ("batches", "trajectories", "legs", "joins", "forwards", "completed"):
        assert tstats[key] == jstats[key], key
    tier_keys = {k for k in jsnap if k.startswith("tier_")}
    assert tier_keys and {k: tsnap[k] for k in tier_keys} == {k: jsnap[k] for k in tier_keys}


def test_fleet_affinity_groups_near_shapes_on_one_tier_key():
    """``tests/test_tiers.py``'s fleet case: near shapes share one tier key
    (one home), without a ladder raw shapes fragment, and an oversize shape
    routes (submit rejects it later); each key equals the reference's."""
    from repro.serving.fleet import default_affinity as jax_affinity
    from repro_torch.serving.fleet import default_affinity

    def key(i, rows, tiers=None):
        ours = default_affinity(Request(budget=4, x0=_x0(i, rows)), tiers=tiers)
        ref = jax_affinity(JaxRequest(budget=4, x0=jnp.asarray(_x0(i, rows))),
                           tiers=None if tiers is None else JaxShapeLadder(tiers.rungs))
        assert ours == ref
        return ours

    a, b, c = key(60, 5, LADDER), key(61, 7, LADDER), key(62, 13, LADDER)
    assert a == b and a != c
    assert key(60, 5) != key(61, 7)          # no ladder: raw shapes fragment
    assert key(63, 17, LADDER)[3] == (17, 2)
