"""The whisper-medium encoder-decoder family against ``repro.models.whisper``,
on the CPU.

The smoke config (2 + 2 layers, f32) takes the reference's params from
``init_params(PRNGKey(0), cfg)`` as numpy, with every norm redrawn from a
numpy seed so it is live (the reference initializes them to 1). Frames,
latents and tokens are made with numpy from a seed. Tolerances are
``tests/test_kernels.py``'s f32 2e-5, times 4 through attention, as the
other parity files scale them. At the bf16 config the reference raises (its
f32 frames promote the memory to f32, and the decoder's scan refuses the
changed carry); the port casts where JAX promotes and returns finite values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.schedulers import fm_ot as jax_fm_ot
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import whisper as jwhisper
from repro.serving import engine as jengine
from repro.solvers.registry import build_ns as jax_build_ns
from repro_torch.configs import get_config
from repro_torch.core.schedulers import fm_ot
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import whisper as twhisper
from repro_torch.serving import programs
from repro_torch.serving.decode import DecodeGateway
from repro_torch.serving.engine import DecodeEngine, FlowSampler, greedy_demo
from repro_torch.solvers.registry import build_ns
from torch_graph_double import CPUGraph

TOL = 2e-5                       # tests/test_kernels.py, f32
ARCH = "whisper-medium"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL * 4):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _live_norms(tree, rng):
    """The tree with every ``norm*`` leaf redrawn near 1 (numpy)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _live_norms(v, rng)
        elif "norm" in k:
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    tree = _live_norms(tree, np.random.default_rng(3))
    jp = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH, smoke=True)
    tp = twhisper.params_from_jax(tree, cfg, device="cpu")
    frames = _rand(4, (2, cfg.frontend.num_tokens, cfg.d_model), 0.05)
    return jcfg, jp, cfg, tp, frames


@pytest.mark.parametrize("smoke_cfg", [True, False])
def test_config_is_the_reference_config(smoke_cfg):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke_cfg)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke_cfg))
    assert get_config(ARCH, smoke=smoke_cfg).param_count() == \
        jax_get_config(ARCH, smoke=smoke_cfg).param_count()


@pytest.mark.parametrize("step", [0, 3])
def test_frames_draw_is_the_references_to_the_bit(step):
    cfg = get_config(ARCH, smoke=True)
    want = JSyntheticTokens(jax_get_config(ARCH, smoke=True),
                            JDataConfig(batch_size=3, seq_len=7, seed=5)).batch(step)
    got = SyntheticTokens(cfg, DataConfig(batch_size=3, seq_len=7, seed=5),
                          device="cpu").batch(step)
    assert set(got) == set(want) == {"tokens", "frames"}
    assert got["frames"].dtype == torch.float32
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["frames"].numpy(), np.asarray(want["frames"]))


def test_init_params_has_the_reference_tree():
    """The port's draw: the reference's tree, shapes and dtypes (at the smoke
    config in bf16: stacked leaves cast, the two 1-D norms f32)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    want = jax.tree_util.tree_flatten_with_path(
        jmodel.init_params(jax.random.PRNGKey(0), jcfg))[0]
    got = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for path, leaf in want:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype)[6:] == str(leaf.dtype), path


@pytest.mark.parametrize("L,M", [(5, 9), (1, 16), (12, 3)])
def test_cross_attention_matches_reference(smoke, L, M):
    jcfg, jp, cfg, tp, _ = smoke
    x, mem = _rand(L, (2, L, cfg.d_model)), _rand(M + 7, (2, M, cfg.d_model))
    jlayer = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross_attn"])
    tlayer = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    hd = cfg.resolved_head_dim
    want = jattn.cross_attention_forward(jlayer, jnp.asarray(x), jnp.asarray(mem),
                                         n_heads=cfg.n_heads, head_dim=hd)
    got = tattn.cross_attention_forward(tlayer, torch.from_numpy(x), torch.from_numpy(mem),
                                        n_heads=cfg.n_heads, head_dim=hd)
    _close(got, want)


def test_encode_matches_reference(smoke):
    jcfg, jp, cfg, tp, frames = smoke
    want = jwhisper.encode(jp, jcfg, jnp.asarray(frames))
    got = twhisper.encode(tp, cfg, torch.from_numpy(frames))
    assert got.shape == (2, cfg.frontend.num_tokens, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_decoder_hidden_matches_reference(smoke, causal):
    jcfg, jp, cfg, tp, frames = smoke
    h = _rand(8, (2, 11, cfg.d_model))
    memory = np.array(jwhisper.encode(jp, jcfg, jnp.asarray(frames)))
    want = jwhisper.decoder_hidden(jp, jcfg, jnp.asarray(h), jnp.asarray(memory),
                                   causal=causal)
    got = twhisper.decoder_hidden(tp, cfg, torch.from_numpy(h), torch.from_numpy(memory),
                                  causal=causal)
    _close(got, want)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_velocity_matches_reference(smoke, t):
    """The encoder runs inside the velocity call over the batch's frames."""
    jcfg, jp, cfg, tp, frames = smoke
    x = _rand(9, (2, 12, cfg.latent_dim))
    tok = np.random.default_rng(10).integers(0, cfg.vocab, size=(2, 12))
    want = jmodel.velocity(jp, jcfg, jnp.float32(t), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32),
                            "frames": jnp.asarray(frames)})
    got = tmodel.velocity(tp, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(frames)})
    assert got.dtype == torch.float32
    _close(got, want)


def test_velocity_without_frames_names_them(smoke):
    _, _, cfg, tp, _ = smoke
    with pytest.raises(ValueError, match="frames"):
        tmodel.velocity(tp, cfg, torch.tensor(0.5), torch.zeros((1, 4, cfg.latent_dim)),
                        {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def _decode_both(smoke, tokens, steps):
    """Decode ``steps`` columns of ``tokens`` over an encoded memory in both
    packages; returns (port logits, reference logits, port state)."""
    jcfg, jp, cfg, tp, frames = smoke
    B = tokens.shape[0]
    jstate = jmodel.init_decode_state(jcfg, B, 8, jnp.float32, num_frames=frames.shape[1])
    jstate = jstate._replace(memory=jwhisper.encode(jp, jcfg, jnp.asarray(frames)))
    tstate = tmodel.init_decode_state(cfg, B, 8, torch.float32, "cpu",
                                      num_frames=frames.shape[1])
    tstate.memory.copy_(twhisper.encode(tp, cfg, torch.from_numpy(frames)))
    jout, tout = [], []
    for i in range(steps):
        jl, jstate = jmodel.decode_apply(jp, jcfg, jnp.asarray(tokens[:, i], jnp.int32),
                                         jstate)
        tl, same = tmodel.decode_apply(tp, cfg, torch.from_numpy(tokens[:, i]), tstate)
        assert same is tstate                     # updated in place
        jout.append(jl)
        tout.append(tl)
    assert int(tstate.index) == int(jstate.index) == steps
    return torch.stack(tout, 1), jnp.stack(jout, 1), tstate


def test_decode_step_over_an_encoded_memory_matches_reference(smoke):
    cfg = smoke[2]
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, size=(2, 6))
    got, want, state = _decode_both(smoke, tokens, 6)
    assert got.shape == (2, 6, cfg.vocab)
    _close(got, want)
    assert state.k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_decode_matches_prefill(smoke):
    """tests/test_archs_smoke.py::test_decode_matches_prefill: token by token
    equals the reference's prefill logits (2e-2, as there), and the port's
    own full-sequence decoder over the same memory at f32."""
    jcfg, jp, cfg, tp, frames = smoke
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, size=(2, 8))
    got, _, state = _decode_both(smoke, tokens, 8)
    ref = jmodel.lm_apply(jp, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                                     "frames": jnp.asarray(frames)})
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-2, rtol=2e-2)
    h = twhisper.decoder_hidden(tp, cfg, tp["embed"][torch.from_numpy(tokens)], state.memory)
    _close(got, h @ tp["embed"].T)


def test_tanh_gelu_is_jax_gelu():
    x = _rand(13, (4, 64), 3.0)
    p = {"w1": torch.eye(64), "w2": torch.eye(64)}
    np.testing.assert_allclose(twhisper._mlp(p, torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=TOL, rtol=TOL)


def _bf16(smoke):
    jcfg, jp, cfg, tp, frames = smoke
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    tb = dataclasses.replace(cfg, dtype="bfloat16")
    jpb = jax.tree.map(lambda a: a if a.ndim == 1 else a.astype(jnp.bfloat16), jp)
    tpb = twhisper.params_from_jax(jax.tree.map(np.asarray, jp), tb, device="cpu",
                                   dtype=torch.bfloat16)
    return jb, jpb, tb, tpb, frames


@pytest.mark.parametrize("path", ["velocity", "greedy_demo", "decode_over_memory"])
def test_bf16_rule(smoke, path):
    """At bf16 the reference raises its scan's TypeError on each encdec path;
    the port casts the frames to the weights' dtype and the memory to the
    decoder state's and returns finite values."""
    jb, jpb, tb, tpb, frames = _bf16(smoke)
    x = _rand(14, (2, 6, tb.latent_dim))
    tok = np.random.default_rng(15).integers(0, tb.vocab, size=(2, 6))
    with pytest.raises(TypeError, match="carry"):
        if path == "velocity":
            jmodel.velocity(jpb, jb, jnp.float32(0.5), jnp.asarray(x),
                            {"tokens": jnp.asarray(tok, jnp.int32),
                             "frames": jnp.asarray(frames)})
        elif path == "greedy_demo":
            jengine.greedy_demo(jengine.DecodeEngine(params=jpb, cfg=jb), 2, 3, 8)
        else:
            state = jmodel.init_decode_state(jb, 2, 8, jnp.float32,
                                             num_frames=frames.shape[1])
            state = state._replace(memory=jwhisper.encode(jpb, jb, jnp.asarray(frames)))
            jmodel.decode_apply(jpb, jb, jnp.asarray(tok[:, 0], jnp.int32), state)
    if path == "velocity":
        out = tmodel.velocity(tpb, tb, torch.tensor(0.5), torch.from_numpy(x),
                              {"tokens": torch.from_numpy(tok),
                               "frames": torch.from_numpy(frames)})
        assert out.dtype == torch.float32 and out.shape == x.shape
    elif path == "greedy_demo":
        out, _ = greedy_demo(DecodeEngine(params=tpb, cfg=tb), 2, 3, 8)
        assert out.shape == (2, 3) and int(out.min()) >= 0 and int(out.max()) < tb.vocab
        return
    else:
        state = tmodel.init_decode_state(tb, 2, 8, torch.float32, "cpu",
                                         num_frames=frames.shape[1])
        memory = twhisper.encode(tpb, tb, torch.from_numpy(frames))
        assert memory.dtype == torch.bfloat16
        state.memory.copy_(memory)
        out, _ = tmodel.decode_apply(tpb, tb, torch.from_numpy(tok[:, 0]), state)
    assert bool(torch.isfinite(out.float()).all())


def test_flow_sampler_matches_reference_and_graphs_equal_eager(smoke, monkeypatch):
    """A FlowSampler request with frames (euler NFE 4) against the
    reference's on the same noise; through ``CPUGraph`` equal to eager to the
    bit, one program."""
    jcfg, jp, cfg, tp, frames = smoke
    tok = np.random.default_rng(16).integers(0, cfg.vocab, size=(2, 10))
    x0 = _rand(17, (2, 10, cfg.latent_dim))
    jbatch = {"tokens": jnp.asarray(tok, jnp.int32), "frames": jnp.asarray(frames)}
    tbatch = {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(frames)}
    jfield = jmodel.velocity_field(jp, jcfg, jax_fm_ot(), jbatch)
    want = jengine.FlowSampler(params=jp, cfg=jcfg, sched=jfield.scheduler,
                               solver=jax_build_ns("euler", 4, jfield)).sample_from(
        jbatch, jnp.asarray(x0))
    field = tmodel.velocity_field(tp, cfg, fm_ot(), tbatch)
    kw = dict(params=tp, cfg=cfg, sched=fm_ot(), solver=build_ns("euler", 4, field))
    eager = FlowSampler(**kw).sample_from(tbatch, x0)
    _close(eager, want, TOL * 4 * 4)
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    sampler = FlowSampler(**kw)
    first, again = sampler.sample_from(tbatch, x0), sampler.sample_from(tbatch, x0)
    assert torch.equal(first, eager) and torch.equal(again, eager)
    assert sampler.programs.stats()["programs"] == 1


def test_decode_gateway_refuses_encdec(smoke):
    _, _, cfg, tp, _ = smoke
    with pytest.raises(TypeError, match="encoder-decoder"):
        DecodeGateway(DecodeEngine(params=tp, cfg=cfg))


def test_greedy_demo_matches_reference(smoke):
    """The launcher's decode mode without --gateway: greedy over a zeroed
    memory of the reference's default 1500 frames, the same tokens."""
    jcfg, jp, cfg, tp, _ = smoke
    want, _ = jengine.greedy_demo(jengine.DecodeEngine(params=jp, cfg=jcfg), 2, 5, 8)
    got, _ = greedy_demo(DecodeEngine(params=tp, cfg=cfg), 2, 5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
