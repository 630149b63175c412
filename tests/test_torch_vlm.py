"""The internvl2-26b vision-language family against ``repro.models.vlm``, on
the CPU.

The smoke config (2 layers, f32) takes the reference's params from
``init_params(PRNGKey(0), cfg)`` as numpy, the norms redrawn from a numpy
seed so they are live. Patches, latents and tokens are made with numpy from
a seed. Tolerances are ``tests/test_kernels.py``'s f32 2e-5, times 4 through
attention. Decode is the dense family's (``transformer.decode_step``), over
a dense cache and over a paged one (the kernel's plain version here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import model as jmodel
from repro.models import vlm as jvlm
from repro_torch.configs import get_config
from repro_torch.core.schedulers import fm_ot
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.models import model as tmodel
from repro_torch.models import vlm as tvlm
from repro_torch.serving import programs
from repro_torch.serving.engine import FlowSampler
from repro_torch.solvers.registry import build_ns
from torch_graph_double import CPUGraph

TOL = 2e-5                       # tests/test_kernels.py, f32
ARCH = "internvl2-26b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL * 4):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    for key in ("norm1", "norm2"):
        v = tree["layers"][key]
        tree["layers"][key] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    tree["final_norm"] = (1.0 + 0.1 * rng.standard_normal(tree["final_norm"].shape)
                          ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH, smoke=True)
    tp = tvlm.params_from_jax(tree, cfg, device="cpu")
    patches = _rand(4, (2, cfg.frontend.num_tokens, cfg.frontend.embed_dim), 0.05)
    return jcfg, jp, cfg, tp, patches


@pytest.mark.parametrize("smoke_cfg", [True, False])
def test_config_is_the_reference_config(smoke_cfg):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke_cfg)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke_cfg))
    assert get_config(ARCH, smoke=smoke_cfg).param_count() == \
        jax_get_config(ARCH, smoke=smoke_cfg).param_count()


@pytest.mark.parametrize("step", [0, 2])
def test_patches_draw_is_the_references_to_the_bit(step):
    want = JSyntheticTokens(jax_get_config(ARCH, smoke=True),
                            JDataConfig(batch_size=3, seq_len=5, seed=7)).batch(step)
    got = SyntheticTokens(get_config(ARCH, smoke=True),
                          DataConfig(batch_size=3, seq_len=5, seed=7), device="cpu").batch(step)
    assert set(got) == set(want) == {"tokens", "patches"}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["patches"].numpy(), np.asarray(want["patches"]))


def test_init_params_has_the_reference_tree():
    """The dense tree plus the projector, in the model dtype (bf16 here)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    want = jax.tree_util.tree_flatten_with_path(
        jmodel.init_params(jax.random.PRNGKey(0), jcfg))[0]
    got = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert got["projector"]["w1"].dtype == torch.bfloat16
    for path, leaf in want:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype), path


def test_project_patches_matches_reference(smoke):
    jcfg, jp, cfg, tp, patches = smoke
    _close(tvlm.project_patches(tp, torch.from_numpy(patches)),
           jvlm.project_patches(jp, jnp.asarray(patches)), TOL)


@pytest.mark.parametrize("with_patches", [True, False])
@pytest.mark.parametrize("t", [0.2, 0.9])
def test_velocity_matches_reference(smoke, with_patches, t):
    """With patches the LM runs over [patches; latents] at positions
    arange(m + S) and returns the last S; without them it is the dense path."""
    jcfg, jp, cfg, tp, patches = smoke
    x = _rand(9, (2, 10, cfg.latent_dim))
    tok = np.random.default_rng(10).integers(0, cfg.vocab, size=(2, 10))
    jb, tb = {"tokens": jnp.asarray(tok, jnp.int32)}, {"tokens": torch.from_numpy(tok)}
    if with_patches:
        jb["patches"], tb["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    want = jmodel.velocity(jp, jcfg, jnp.float32(t), jnp.asarray(x), jb)
    got = tmodel.velocity(tp, cfg, torch.tensor(t), torch.from_numpy(x), tb)
    assert got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_matches_reference(smoke, paged):
    """Text decode after the prefix: the dense step over a dense cache, or
    over a paged pool (two pages a row, the kernel's plain version)."""
    jcfg, jp, cfg, tp, _ = smoke
    B, steps = 2, 6
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, size=(B, steps))
    if paged:
        table = np.array([[1, 2], [3, 4]], np.int32)
        jstate = jmodel.init_paged_decode_state(jcfg, B, 5, 4, 2, jnp.float32)
        jstate = jstate._replace(block_table=jnp.asarray(table))
        tstate = tmodel.init_paged_decode_state(cfg, B, 5, 4, 2, torch.float32, "cpu")
        tstate.block_table.copy_(torch.from_numpy(table))
    else:
        jstate = jmodel.init_decode_state(jcfg, B, 8, jnp.float32)
        tstate = tmodel.init_decode_state(cfg, B, 8, torch.float32, "cpu")
    for i in range(steps):
        jl, jstate = jmodel.decode_apply(jp, jcfg, jnp.asarray(tokens[:, i], jnp.int32),
                                         jstate, paged_kernel=paged)
        tl, _ = tmodel.decode_apply(tp, cfg, torch.from_numpy(tokens[:, i]), tstate,
                                    paged_kernel=paged)
        _close(tl, jl)
    assert tmodel.decode_state_batch_axes(cfg, paged=paged) == \
        tuple(jmodel.decode_state_batch_axes(jcfg, paged=paged))


def test_flow_sampler_with_patches_graphs_equal_eager(smoke, monkeypatch):
    """The patches ride into the sampler's program as an input: through
    ``CPUGraph`` equal to eager to the bit, one program for two requests, and
    the same program kind keyed apart from a tokens-only batch."""
    _, _, cfg, tp, patches = smoke
    tok = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, size=(2, 6)))
    batch = {"tokens": tok, "patches": torch.from_numpy(patches)}
    x0 = _rand(13, (2, 6, cfg.latent_dim))
    field = tmodel.velocity_field(tp, cfg, fm_ot(), batch)
    kw = dict(params=tp, cfg=cfg, sched=fm_ot(), solver=build_ns("euler", 4, field))
    eager = FlowSampler(**kw).sample_from(batch, x0)
    plain = FlowSampler(**kw).sample_from({"tokens": tok}, x0)
    assert not torch.equal(eager, plain)              # the patches condition it
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    sampler = FlowSampler(**kw)
    runs = [sampler.sample_from(batch, x0) for _ in range(2)]
    assert all(torch.equal(r, eager) for r in runs)
    assert torch.equal(sampler.sample_from({"tokens": tok}, x0), plain)
    assert sampler.programs.stats()["programs"] == 2
