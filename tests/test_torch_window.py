"""Sliding-window full-sequence attention and the query-chunked form, the
port against the JAX reference, on the CPU.

``_chunked_attend`` is held against the reference's at window 0, 3 and 8,
causal and full, with the chunk dividing L. ``attention_forward`` with a
window runs on the card through the same masked plain path as on the CPU
(the reference's flash kernel takes no window either): here its input
reports ``is_cuda`` (``OnCard``), so the call takes the card's branch, and
must launch no flash kernel and give the reference's masked result, alone
and under an installed ``q_chunk`` context (the reference's under its own).
Inputs are numpy draws from a seed; the reference's yi-6b smoke layer's
weights go to both sides. Tolerance: ``tests/test_kernels.py``'s f32 TOL
(2e-5), times 4 after the projections, as the attention tests scale it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import context as jcontext
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.distributed import context
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import params_from_jax

TOL = 2e-5
B, L, KV, G, HD = 2, 24, 2, 3, 16


class OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: ``attention_forward`` takes the
    card's branch for it."""

    @property
    def is_cuda(self):
        return True


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, L, KV, G, HD), (B, L, KV, HD), (B, L, KV, HD))]


@pytest.mark.parametrize("qc", [4, 8, 12])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 3, 8])
def test_chunked_attend_matches_the_reference(window, causal, qc):
    q, k, v = _qkv(window * 10 + qc)
    positions = np.arange(L) + 5                     # absolute positions, not 0-based
    want = jattn._chunked_attend(*(jnp.asarray(x) for x in (q, k, v)),
                                 jnp.asarray(positions), causal, window, qc)
    got = tattn._chunked_attend(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.from_numpy(positions), causal, window, qc)
    assert got.shape == (B, L, KV, G, HD)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attend_equals_the_unchunked_masked_path(window):
    """The chunks compute the rows of the one masked call."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7))
    positions = torch.arange(L)
    whole = tattn._grouped_attend(q, k, v, tattn._position_mask(positions, positions, window))
    _close(tattn._chunked_attend(q, k, v, positions, True, window, 6), whole, 1e-6)


@pytest.fixture(scope="module")
def layer():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
              rope_theta=cfg.rope_theta)
    return jp, tp, cfg, kw


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("q_chunk", [0, 8])
@pytest.mark.parametrize("window", [3, 8])
def test_windowed_card_route_matches_the_reference_masked_path(layer, window, q_chunk):
    """``attention_forward(window > 0)`` on a tensor that reports the card:
    no flash launch, the reference's result (its masked path, or its
    ``_chunked_attend`` under the same ``q_chunk``)."""
    jp, tp, cfg, kw = layer
    x = (0.5 * np.random.default_rng(window).standard_normal((2, L, cfg.d_model))
         ).astype(np.float32)
    positions = np.arange(L)
    if q_chunk:
        jcontext.install(_one_device_mesh(), q_chunk=q_chunk)
        context.install({"data": 1, "model": 1}, q_chunk=q_chunk)
    try:
        want = jattn.attention_forward(jp, jnp.asarray(x), jnp.asarray(positions),
                                       window=window, **kw)
        before = fa_mod.COUNTER.launches
        got = tattn.attention_forward(tp, torch.from_numpy(x).as_subclass(OnCard),
                                      torch.from_numpy(positions), window=window, **kw)
    finally:
        jcontext.clear()
        context.clear()
    assert fa_mod.COUNTER.launches == before
    _close(got, want, TOL * 4)


def test_windowed_card_route_differentiates_through_autograd(layer):
    """The card's windowed path has no backward kernel: autograd of the
    plain path, the reference's ``jax.grad`` of its masked path."""
    jp, tp, cfg, kw = layer
    x = (0.5 * np.random.default_rng(2).standard_normal((2, L, cfg.d_model))).astype(np.float32)
    positions = np.arange(L)

    def jloss(x):
        return jnp.mean(jattn.attention_forward(jp, x, jnp.asarray(positions), window=5,
                                                **kw) ** 2)

    want = jax.grad(jloss)(jnp.asarray(x))
    tx = torch.from_numpy(x).as_subclass(OnCard).requires_grad_(True)
    out = tattn.attention_forward(tp, tx, torch.from_numpy(positions), window=5, **kw)
    (got,) = torch.autograd.grad(torch.mean(out ** 2), tx)
    _close(got, want, TOL * 4)
