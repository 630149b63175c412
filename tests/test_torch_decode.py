"""The port's decode plane against the JAX reference, on the CPU: decode
attention (dense, ring buffer, paged through the kernel's plain version and
through the dense gather), ``decode_step`` logits, the ``DecodeEngine`` slot
API and the sampling filter.

yi-6b's smoke config (2 layers, d_model 256, f32). The reference's params
from ``init_params(PRNGKey(0), cfg)`` go through ``params_from_jax``; tokens,
masks and block tables are made with numpy and handed to both sides. The
reference runs its Pallas paged kernel in interpret mode, as its own tests
do. Tolerances are ``tests/test_kernels.py``'s f32 2e-5, times 4 where the
value went through attention, as that file scales attention; where a case
asks for more it says why. The port writes its caches in place, so every
comparison of state clones first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import paged_attention as pa_mod
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving import engine as tengine

TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, scale=4):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL * scale, rtol=TOL * scale)


def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta)


def _layer0(setup):
    jcfg, jparams, cfg, params = setup
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    return jp, tp


def _table(seed, B, nb):
    rng = np.random.default_rng(seed)
    return (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)


@pytest.mark.parametrize("window,slots", [(0, 16), (4, 4)])
def test_decode_attention_over_a_teacher_forced_sequence(setup, window, slots):
    """Dense decode attention, per-row positions (rows start 3 apart), and
    the ring buffer when window > 0 (the sequence runs past its 4 slots)."""
    _, _, cfg, _ = setup
    jp, tp = _layer0(setup)
    B, T, hd = 2, 9, cfg.resolved_head_dim
    xs = np.random.default_rng(1).standard_normal((T, B, 1, cfg.d_model)).astype(np.float32)
    start = np.asarray([0, 3], np.int32)
    jcache = jattn.init_kv_cache(B, slots, cfg.n_kv_heads, hd, jnp.float32)
    jcache = jcache._replace(index=jnp.asarray(start))
    tcache = tattn.init_kv_cache(B, slots, cfg.n_kv_heads, hd, torch.float32, "cpu")
    tcache = tcache._replace(index=torch.from_numpy(start))
    for t in range(T):
        want, jcache = jattn.decode_attention(jp, jnp.asarray(xs[t]), jcache, window=window,
                                              **_attn_kw(cfg))
        got, tcache = tattn.decode_attention(tp, torch.from_numpy(xs[t]), tcache,
                                             window=window, **_attn_kw(cfg))
        _close(got, want)
    np.testing.assert_array_equal(tcache.index.numpy(), np.asarray(jcache.index))
    _close(tcache.k, jcache.k)


@pytest.mark.parametrize("kernel", [False, True])
def test_decode_attention_paged_over_a_teacher_forced_sequence(setup, kernel):
    """Paged decode attention against the reference's, kernel path (the
    port's plain version, the reference's Pallas kernel in interpret mode)
    and dense-gather path; the pool after the in-place writes equals the
    reference's rebuilt pool."""
    _, _, cfg, _ = setup
    jp, tp = _layer0(setup)
    B, T, ps, nb, hd = 3, 7, 4, 3, cfg.resolved_head_dim
    xs = np.random.default_rng(2).standard_normal((T, B, 1, cfg.d_model)).astype(np.float32)
    table = _table(3, B, nb)
    table[2] = 0                                   # an inactive row on the trash page
    pos = np.asarray([0, 5, 0], np.int32)
    shape = (1 + B * nb, ps, cfg.n_kv_heads, hd)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for t in range(T):
        want, jk, jv = jattn.decode_attention_paged(
            jp, jnp.asarray(xs[t]), jk, jv, jnp.asarray(table), jnp.asarray(pos + t),
            kernel=kernel, **_attn_kw(cfg))
        got = tattn.decode_attention_paged(
            tp, torch.from_numpy(xs[t]), tk, tv, torch.from_numpy(table),
            torch.from_numpy(pos + t), kernel=kernel, **_attn_kw(cfg))
        _close(got[:2], want[:2])                  # rows that own pages
    _close(tk[1:], jk[1:])


def test_paged_dense_gather_bit_identical_to_dense_cache(setup):
    """With nb * page_size == cache slots, the dense-gather path gives the
    dense cache's output bit for bit (same shapes, same ops)."""
    _, _, cfg, _ = setup
    _, tp = _layer0(setup)
    B, ps, nb, hd = 2, 4, 4, cfg.resolved_head_dim
    table = torch.from_numpy(_table(4, B, nb))
    cache = tattn.init_kv_cache(B, nb * ps, cfg.n_kv_heads, hd, torch.float32, "cpu")
    cache = cache._replace(index=torch.tensor([0, 2], dtype=torch.int32))
    tk = torch.zeros((1 + B * nb, ps, cfg.n_kv_heads, hd))
    tv = torch.zeros_like(tk)
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (6, B, 1, cfg.d_model)).astype(np.float32))
    for t in range(6):
        pos = cache.index.clone()
        dense, cache = tattn.decode_attention(tp, xs[t], cache, **_attn_kw(cfg))
        paged = tattn.decode_attention_paged(tp, xs[t], tk, tv, table, pos, **_attn_kw(cfg))
        assert torch.equal(dense, paged)


def _paged_state(cfg, B, ps, nb, table, dtype=torch.float32):
    state = tmodel.init_paged_decode_state(cfg, B, 1 + B * nb, ps, nb, dtype, "cpu")
    return state._replace(block_table=torch.from_numpy(table))


@pytest.mark.parametrize("paged,kernel", [(False, False), (True, False), (True, True)])
def test_decode_step_logits_over_a_teacher_forced_sequence(setup, paged, kernel):
    jcfg, jparams, cfg, params = setup
    B, T, ps, nb = 2, 6, 4, 2
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(T, B)).astype(np.int32)
    if paged:
        table = _table(7, B, nb)
        jstate = jmodel.init_paged_decode_state(jcfg, B, 1 + B * nb, ps, nb, jnp.float32)
        jstate = jstate._replace(block_table=jnp.asarray(table))
        tstate = _paged_state(cfg, B, ps, nb, table)
    else:
        jstate = jmodel.init_decode_state(jcfg, B, 8, jnp.float32)
        tstate = tmodel.init_decode_state(cfg, B, 8, torch.float32, "cpu")
    before = pa_mod.COUNTER.launches
    for t in range(T):
        want, jstate = jmodel.decode_apply(jparams, jcfg, jnp.asarray(toks[t]), jstate,
                                           paged_kernel=kernel)
        got, tstate = tmodel.decode_apply(params, cfg, torch.from_numpy(toks[t]), tstate,
                                          paged_kernel=kernel)
        assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
        _close(got, want)
    assert pa_mod.COUNTER.launches == before          # the CPU runs the plain version
    np.testing.assert_array_equal(np.broadcast_to(tstate.index.numpy(), (B,)),
                                  np.broadcast_to(np.asarray(jstate.index), (B,)))


def test_vlm_decode_states_are_the_dense_familys(setup):
    """The vlm family, once refused here, decodes over the dense family's
    caches, dense and paged; the ssm family still has no pageable state."""
    import dataclasses

    _, _, cfg, _ = setup
    vlm = dataclasses.replace(cfg, family="vlm")
    dense = tmodel.init_decode_state(vlm, 2, 8, torch.float32, "cpu")
    assert isinstance(dense, tattn.KVCache) and dense.k.shape[:3] == (cfg.n_layers, 2, 8)
    paged = tmodel.init_paged_decode_state(vlm, 2, 5, 4, 2, torch.float32, "cpu")
    assert isinstance(paged, tattn.PagedKVCache) and paged.block_table.shape == (2, 2)
    with pytest.raises(TypeError, match="pageable"):
        tmodel.init_paged_decode_state(dataclasses.replace(cfg, family="ssm"), 2, 5, 4, 2,
                                       torch.float32, "cpu")


# -- the engine's slot API ---------------------------------------------------


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, jparams, cfg, params = setup
    out = {}
    for name, kw in (("dense", {}), ("paged", dict(page_size=4, paged_kernel=True))):
        out[name] = (jengine.DecodeEngine(params=jparams, cfg=jcfg, **kw),
                     tengine.DecodeEngine(params=params, cfg=cfg, **kw))
    return out


def _clone(state):
    return state._replace(**{k: v.clone() for k, v in state._asdict().items()})


def _assert_state_close(tstate, jstate):
    for name, leaf in tstate._asdict().items():
        want = getattr(jstate, name)
        if leaf.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=name)
        else:
            _close(leaf, want)


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_slot_api_matches_the_reference_engine(engines, name):
    """reset_slots, prefill_slots and step_slots on the same masks: same
    tokens, same positions, same caches (allclose) as the reference's."""
    jeng, teng = engines[name]
    S, C, cache_slots = 3, 4, 16
    jstate = jeng.init_slot_state(S, cache_slots)
    tstate = teng.init_slot_state(S, cache_slots)
    if name == "paged":
        table = _table(8, S, cache_slots // 4)
        jstate = jeng.with_block_table(jstate, table)
        tstate = teng.with_block_table(tstate, table)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, teng.cfg.vocab, size=(S, C)).astype(np.int32)
    lengths = np.asarray([4, 2, 0], np.int32)
    mask = np.asarray([True, True, False])
    jstate = jeng.prefill_slots(jnp.asarray(tokens), jnp.asarray(lengths), jstate,
                                jnp.asarray(mask))
    tstate = teng.prefill_slots(tokens, lengths, tstate, mask)
    _assert_state_close(tstate, jstate)
    feed = tokens[:, 0].copy()
    for step, active in enumerate(([True, True, False], [True, False, True],
                                   [False, True, True])):
        active = np.asarray(active)
        if step == 2:
            free = np.asarray([False, False, True])
            jstate = jeng.reset_slots(jstate, jnp.asarray(free))
            tstate = teng.reset_slots(tstate, free)
        jn, jstate = jeng.step_slots(jnp.asarray(feed), jstate, jnp.asarray(active))
        tn, tstate = teng.step_slots(feed, tstate, active)
        assert tn.dtype == torch.int32 and not tn.is_cuda
        # an inactive row's token is discarded: the reference's row attended
        # over its new K/V before the mask dropped them, the port's over its
        # kept cell
        np.testing.assert_array_equal(tn.numpy()[active], np.asarray(jn)[active])
        feed = np.where(active, tn.numpy(), feed).astype(np.int32)
        _assert_state_close(tstate, jstate)


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_inactive_rows_keep_their_state(engines, name):
    """After step_slots and prefill_slots, an inactive row's position and
    dense cache rows are unchanged bit for bit; paged, its block table and
    the pool cells it has written (positions < index) are too."""
    _, teng = engines[name]
    S, cache_slots = 3, 16
    state = teng.init_slot_state(S, cache_slots)
    if name == "paged":
        state = teng.with_block_table(state, _table(10, S, cache_slots // 4))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, teng.cfg.vocab, size=(S, 4)).astype(np.int32)
    state = teng.prefill_slots(prompt, np.asarray([4, 3, 2], np.int32), state,
                               np.ones(S, bool))

    def frozen(before, after, row):
        if name == "dense":
            assert torch.equal(after.k[:, row], before.k[:, row])
            assert torch.equal(after.v[:, row], before.v[:, row])
        else:
            assert torch.equal(after.block_table[row], before.block_table[row])
            n = int(before.index[row])
            for p in range(n):
                page = int(before.block_table[row, p // teng.page_size])
                off = p % teng.page_size
                assert torch.equal(after.k_pages[:, page, off], before.k_pages[:, page, off])
                assert torch.equal(after.v_pages[:, page, off], before.v_pages[:, page, off])
        assert int(after.index[row]) == int(before.index[row])

    before = _clone(state)
    _, state = teng.step_slots(prompt[:, 0], state, np.asarray([True, False, True]))
    frozen(before, state, 1)
    assert state.index.tolist() == [5, 3, 3]
    before = _clone(state)
    state = teng.prefill_slots(prompt, np.asarray([2, 2, 2], np.int32), state,
                               np.asarray([False, True, False]))
    frozen(before, state, 0)
    frozen(before, state, 2)
    assert state.index.tolist() == [5, 5, 3]


def test_engine_rejects_what_the_reference_rejects(setup):
    import dataclasses

    _, _, cfg, params = setup
    with pytest.raises(ValueError, match="sliding-window"):
        tengine.DecodeEngine(params=params, cfg=cfg, page_size=4, window=8)
    with pytest.raises(ValueError, match="multiple of"):
        tengine.DecodeEngine(params=params, cfg=cfg, page_size=5).init_slot_state(2, 16)
    with pytest.raises(TypeError, match="pageable"):
        tengine.DecodeEngine(params=params, cfg=dataclasses.replace(cfg, family="hybrid"),
                             page_size=4)
    eng = tengine.DecodeEngine(params=params, cfg=cfg)
    assert eng.seq_capacity_bounded and not eng.paged
    assert not tengine.DecodeEngine(params=params, cfg=cfg, window=4).seq_capacity_bounded


def test_greedy_demo_matches_the_reference(setup, engines):
    jeng, teng = engines["dense"]
    want, _ = jengine.greedy_demo(jeng, 2, 6, 16, prompt=jnp.asarray([3, 7], jnp.int32))
    got, ms = tengine.greedy_demo(teng, 2, 6, 16, prompt=torch.tensor([3, 7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ms > 0


# -- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_fed_the_references_gumbel_draws(seed):
    """The filter (temperature, top-k, top-p) and the Gumbel-max draw, fed
    the reference's own Gumbel noise, pick the reference's tokens; rows at
    temperature 0 are the exact argmax."""
    B, V = 6, 64
    logits = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    gumbel = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
    temps = np.asarray([0.0, 1.0, 0.7, 2.0, 1.0, 0.5], np.float32)
    top_ks = np.asarray([0, 0, 5, 1, 0, 3], np.int32)
    top_ps = np.asarray([1.0, 0.9, 1.0, 1.0, 0.3, 0.8], np.float32)
    want = jengine.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps),
                                 jnp.asarray(top_ks), jnp.asarray(top_ps))
    got = tengine.sample_tokens(torch.from_numpy(logits), torch.from_numpy(gumbel),
                                torch.from_numpy(temps), torch.from_numpy(top_ks),
                                torch.from_numpy(top_ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == int(np.argmax(logits[0]))


def test_seeded_noise_depends_only_on_seed_and_step():
    a = tengine.gumbel_noise([tengine.fold_in(7, 3), 0], [2, 0], [1.0, 0.0], 32, "cpu")
    b = tengine.gumbel_noise([tengine.fold_in(7, 3)], [2], [1.0], 32, "cpu")
    c = tengine.gumbel_noise([tengine.fold_in(7, 3)], [3], [1.0], 32, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(b, c)
    assert torch.equal(a[1], torch.zeros(32))               # greedy rows draw nothing
    assert len({tengine.fold_in(s, u) for s in range(4) for u in range(4)}) == 16
    assert all(0 <= tengine.fold_in(s, 5) < 2 ** 63 for s in range(8))
    with pytest.raises(ValueError):
        tengine.SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError):
        tengine.SamplingParams(top_p=0.0)
