"""The five configs this slice adds (yi-34b, phi3-medium-14b, command-r-35b,
qwen3-moe-30b-a3b, qwen3-moe-235b-a22b) against the reference's, and the
three dense ones served by the port's dense family on the CPU.

Each dense config's smoke model (2 layers, f32; command-r-35b's parallel
block and tied embeddings included) takes the reference's params from
``init_params(PRNGKey(0), cfg)`` as numpy, with the norms redrawn so they
are live. Inputs and tokens are made with numpy from a seed. Tolerances are
``tests/test_kernels.py``'s f32 2e-5, times 4 through attention and a
sampler's NFE, as the other parity files scale them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.serving import decode as jdecode
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import DecodeEngine

TOL = 2e-5                       # tests/test_kernels.py, f32
NEW = ("phi3-medium-14b", "command-r-35b", "yi-34b", "qwen3-moe-235b-a22b",
       "qwen3-moe-30b-a3b")
DENSE = ("phi3-medium-14b", "command-r-35b", "yi-34b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL * 4, **kw):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, **kw)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


@pytest.mark.parametrize("arch", NEW)
def test_full_config_matches_assignment(arch):
    """tests/test_archs_smoke.py::test_full_config_matches_assignment, on the
    port's registry."""
    cfg = get_config(arch)
    spec = {
        "phi3-medium-14b": (40, 5120, 40, 10, 17920, 100352),
        "command-r-35b": (40, 8192, 64, 8, 22528, 256000),
        "yi-34b": (60, 7168, 56, 8, 20480, 64000),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
        "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 768, 151936),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab) == spec
    assert cfg.resolved_head_dim == 128 and cfg.n_heads % cfg.n_kv_heads == 0
    if arch.startswith("qwen3-moe"):
        assert cfg.moe.num_experts == 128 and cfg.moe.top_k == 8 and cfg.qk_norm
    if arch == "command-r-35b":
        assert cfg.parallel_block and cfg.tie_embeddings


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", NEW)
def test_config_is_the_reference_config(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert get_config(arch, smoke=smoke).param_count() == \
        jax_get_config(arch, smoke=smoke).param_count()


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.array, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    for key in ("norm1", "norm2"):
        if key in tree["layers"]:
            leaf = tree["layers"][key]
            tree["layers"][key] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
    cfg = get_config(arch, smoke=True)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(tree, cfg, "cpu")


def test_the_dense_family_serves_them(models):
    jcfg, jparams, cfg, params = models
    assert cfg.family == "dense"
    assert ("lm_head" in params) == (not cfg.tie_embeddings) == ("lm_head" in jparams)
    assert ("norm2" in params["layers"]) == (not cfg.parallel_block)


@pytest.mark.parametrize("t", [0.1, 0.8])
def test_velocity(models, t):
    jcfg, jparams, cfg, params = models
    x = _rand(2, (2, 16, cfg.latent_dim))
    tok = _tokens(3, 2, 16, cfg.vocab)
    want = jmodel.velocity(jparams, jcfg, jnp.float32(t), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tmodel.velocity(params, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


def test_velocity_unconditional_branch(models):
    jcfg, jparams, cfg, params = models
    x = _rand(4, (2, 10, cfg.latent_dim))
    want = jmodel.velocity(jparams, jcfg, jnp.float32(0.3), jnp.asarray(x), None)
    got = tmodel.velocity(params, cfg, torch.tensor(0.3), torch.from_numpy(x), None)
    _close(got, want)


@pytest.mark.parametrize("paged,kernel", [(False, False), (True, True)])
def test_decode_logits_over_a_teacher_forced_sequence(models, paged, kernel):
    """Six steps of ``decode_apply`` over a dense cache and over a paged one
    (the kernel's plain version; the reference's Pallas kernel in interpret
    mode): logits and argmax equal the reference's."""
    jcfg, jparams, cfg, params = models
    B, T, ps, nb = 2, 6, 4, 2
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(T, B)).astype(np.int32)
    if paged:
        table = (np.random.default_rng(6).permutation(B * nb) + 1).reshape(B, nb)
        table = table.astype(np.int32)
        jstate = jmodel.init_paged_decode_state(jcfg, B, 1 + B * nb, ps, nb, jnp.float32)
        jstate = jstate._replace(block_table=jnp.asarray(table))
        tstate = tmodel.init_paged_decode_state(cfg, B, 1 + B * nb, ps, nb, torch.float32,
                                                "cpu")
        tstate = tstate._replace(block_table=torch.from_numpy(table))
    else:
        jstate = jmodel.init_decode_state(jcfg, B, 8, jnp.float32)
        tstate = tmodel.init_decode_state(cfg, B, 8, torch.float32, "cpu")
    for t in range(T):
        want, jstate = jmodel.decode_apply(jparams, jcfg, jnp.asarray(toks[t]), jstate,
                                           paged_kernel=kernel)
        got, tstate = tmodel.decode_apply(params, cfg, torch.from_numpy(toks[t]), tstate,
                                          paged_kernel=kernel)
        _close(got, want, err_msg=f"step {t}")
        assert got.argmax(-1).tolist() == np.asarray(jnp.argmax(want, -1)).tolist()


def test_decode_matches_prefill(models):
    """Token-by-token decode reproduces the reference's full-sequence
    ``lm_apply`` logits (tests/test_archs_smoke.py's check, at its 2e-2)."""
    jcfg, jparams, cfg, params = models
    tok = _tokens(7, 2, 8, cfg.vocab)
    want = jmodel.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tok, jnp.int32)})
    state = tmodel.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    got = torch.stack([tmodel.decode_apply(params, cfg, torch.from_numpy(tok[:, i]),
                                           state)[0] for i in range(8)], dim=1)
    _close(got, want, 2e-2)


def test_served_tokens_match_the_reference_gateway(models):
    """A mixed request list through both paged decode gateways: the same
    tokens, slots and join steps, and the same counts."""
    jcfg, jparams, cfg, params = models
    spec = [([3, 7], 5), ([5], 3), ([9, 1, 4, 4, 2, 8], 4), ([2, 2], 6)]
    kw = dict(max_slots=2, cache_slots=16, prefill_chunk=4)
    ekw = dict(page_size=4, paged_kernel=True)
    jgw = jdecode.DecodeGateway(jengine.DecodeEngine(params=jparams, cfg=jcfg, **ekw), **kw)
    tgw = DecodeGateway(DecodeEngine(params=params, cfg=cfg, **ekw), **kw)
    jfut = [jgw.submit(jdecode.DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    tfut = [tgw.submit(DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    for gw, futures in ((jgw, jfut), (tgw, tfut)):
        while not all(f.done() for f in futures):
            gw.pump()
    for jf, tf in zip(jfut, tfut):
        assert tf.result().tokens.tolist() == jf.result().tokens.tolist()
        for key in ("finish_reason", "new_tokens", "slot", "join_step"):
            assert tf.result().meta[key] == jf.result().meta[key], key
    keys = ("completed", "forwards", "prefill_calls", "joins", "tokens_out")
    assert {k: tgw.stats()[k] for k in keys} == {k: jgw.stats()[k] for k in keys}
