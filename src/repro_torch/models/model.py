"""Unified model API — every family of the reference and the paper's flow
substrate.

Port of ``repro.models.model``: the dense (yi-6b, yi-34b, phi3-medium-14b,
command-r-35b), moe (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b), ssm
(rwkv6-7b), hybrid (zamba2-2.7b), encdec (whisper-medium) and vlm
(internvl2-26b) branches:

  init_params(generator, cfg, device)             -> params tree
  velocity(params, cfg, t, x, batch)              -> u_t(x) over latent sequences
  velocity_field(params, cfg, sched, batch)       -> VelocityField (with CFG)
  init_decode_state(cfg, batch, slots, ...)       -> KV cache, RWKVState, HybridState
                                                     or EncDecState
  init_paged_decode_state(cfg, batch, pages, ...) -> paged KV cache
  decode_apply(params, cfg, token, state)         -> (logits, state)
  cfm_loss(params, cfg, batch, sched, noise=...)  -> the CFM training loss (eq. 56)

``batch`` is a dict: {"tokens": (B, S) long} plus "frames" (encdec) or
"patches" (vlm), the stub frontends' embeddings. Every entry point
dispatches on ``cfg.family``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import Scheduler
from repro_torch.distributed import context
from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_ROADMAP as FLASH_BACKWARD_ROADMAP,
)
from repro_torch.kernels.gla_scan.ops import BACKWARD_ROADMAP as GLA_BACKWARD_ROADMAP
from repro_torch.models import mamba2, moe, rwkv6, transformer, vlm, whisper
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.mamba2 import HybridState
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.models.transformer import latent_targets
from repro_torch.models.whisper import EncDecState

Tensor = torch.Tensor

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
PORTED_FAMILIES = FAMILIES
PAGED_FAMILIES = ("dense", "moe", "vlm")   # KV-cache families that can page

# the families whose flow forward runs a kernel with no backward on the card:
# neither distillation nor backbone training differentiates them there
NO_BACKWARD_ON_CARD = {
    "ssm": f"its gla_scan kernel has no backward ({GLA_BACKWARD_ROADMAP})",
    "hybrid": (f"the gla_scan kernel has no backward ({GLA_BACKWARD_ROADMAP}), nor has "
               f"the flash kernel at its head dim 80 ({FLASH_BACKWARD_ROADMAP})"),
    "encdec": f"the flash kernel has no backward at its head dim 64 ({FLASH_BACKWARD_ROADMAP})",
}

# the param trees' stacked layer subtrees (one leading axis over the layers)
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")

__all__ = ["FAMILIES", "PORTED_FAMILIES", "PAGED_FAMILIES", "NO_BACKWARD_ON_CARD",
           "LAYER_STACKS", "param_template", "unbind_layers", "init_params", "velocity",
           "velocity_field", "latent_targets", "CFMNoise", "draw_cfm_noise", "cfm_loss",
           "init_decode_state", "init_paged_decode_state", "decode_state_batch_axes",
           "decode_apply"]


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    init = {"dense": transformer.init_dense_params, "moe": moe.init_moe_params,
            "ssm": rwkv6.init_rwkv_params, "hybrid": mamba2.init_hybrid_params,
            "encdec": whisper.init_encdec_params, "vlm": vlm.init_vlm_params}
    return init[cfg.family](generator, cfg, device)


def param_template(cfg: ModelConfig) -> dict:
    """``cfg``'s param tree drawn under ``FakeTensorMode``: each leaf's shape
    and dtype, and no storage. A checkpoint restores into it (so the weights
    are never on the device twice), and it sizes the trainer's state."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def unbind_layers(params: dict) -> dict:
    """``params`` with every leaf of its stacked layer subtrees given as the
    tuple of its layers' views (``unbind(0)``), which the families' layer
    loops index as they index the stacked tensor (``transformer.layer_views``).
    Differentiated in this form (the trainer's), each view's gradient is
    that layer's own tensor, and nothing stacks them; through the stacked
    tensor, each layer's ``select`` backward would write a zeroed tensor of
    the whole stack and the L of them be summed."""
    return {k: transformer._tree_map(lambda x: x.unbind(0), v) if k in LAYER_STACKS else v
            for k, v in params.items()}


def _hidden_fn(cfg: ModelConfig, batch: Optional[dict], remat: bool = False):
    """The family's hidden-state function for the flow head; every family
    gets ``remat``, as in the reference. encdec runs the encoder over the
    batch's frames inside every call (the reference does); vlm prepends the
    batch's projected patches, when it has them, and runs the LM over
    positions ``arange(m + S)``, returning the last S."""
    if cfg.family == "encdec":
        if batch is None or "frames" not in batch:
            raise ValueError("the encdec family's velocity needs the batch's audio "
                             "frames (batch['frames'])")

        def encdec(p, c, h, pos):
            memory = whisper.encode(p, c, batch["frames"], remat=remat)
            return whisper.decoder_hidden(p, c, h, memory, pos, remat=remat)
        return encdec
    if cfg.family == "vlm" and batch is not None and "patches" in batch:
        def with_patches(p, c, h, pos):
            pre = vlm.project_patches(p, batch["patches"]).to(h.dtype)
            m = pre.shape[1]
            h = torch.cat([pre, h], dim=1)
            out = transformer.dense_hidden(
                p, c, h, torch.arange(h.shape[1], device=h.device), remat=remat)
            return out[:, m:]
        return with_patches
    if cfg.family == "ssm":
        return lambda p, c, h, pos: rwkv6.rwkv_hidden(p, c, h, remat=remat)
    if cfg.family == "hybrid":
        return lambda p, c, h, pos: mamba2.hybrid_hidden(p, c, h, pos, remat=remat)
    if cfg.family == "moe":
        return lambda p, c, h, pos: moe.moe_hidden(p, c, h, pos, remat=remat)[0]
    return lambda p, c, h, pos: transformer.dense_hidden(p, c, h, pos, remat=remat)


def velocity(params: dict, cfg: ModelConfig, t, x: Tensor,
             batch: Optional[dict] = None, *, remat: bool = False) -> Tensor:
    """u_t(x): x (B, S, latent_dim) -> velocity. ``batch`` provides the
    conditioning (tokens, frames, patches); None = unconditional (CFG).
    ``remat`` recomputes each layer in the backward (BNS training at full
    size needs it)."""
    cond = batch.get("tokens") if batch else None
    return transformer.flow_velocity(params, cfg, t, x, cond,
                                     hidden_fn=_hidden_fn(cfg, batch, remat))


def velocity_field(params: dict, cfg: ModelConfig, sched: Scheduler,
                   batch: Optional[dict] = None, *, cfg_scale: float = 0.0,
                   remat: bool = False) -> VelocityField:
    """Wrap the model for the NS sampler, with classifier-free guidance.
    ``remat`` is passed to ``velocity`` (off for serving, which samples
    under ``torch.no_grad()``)."""

    def u(t, x):
        uc = velocity(params, cfg, t, x, batch, remat=remat)
        if cfg_scale == 0.0:
            return uc
        uu = velocity(params, cfg, t, x, None, remat=remat)
        return (1.0 + cfg_scale) * uc - cfg_scale * uu

    return VelocityField(fn=u, scheduler=sched)


class CFMNoise(NamedTuple):
    """One CFM step's draws, the reference's three keys' worth."""

    t: Tensor        # (B,) f32, uniform on [0, 1)
    x0: Tensor       # (B, S, latent_dim) f32, standard normal
    drop: Tensor     # (B,) bool: drop the row's conditioning (CFG training)


def draw_cfm_noise(generator: torch.Generator, B: int, S: int, latent_dim: int,
                   p_uncond: float = 0.1, device=None) -> CFMNoise:
    """t, x0 and the drop mask from ``generator``, in that order (the
    reference's ``uniform``, ``normal`` and ``bernoulli(p_uncond)``), on
    ``device`` (default: the generator's)."""
    dev = generator.device if device is None else device
    t = torch.rand((B,), generator=generator, device=dev)
    x0 = torch.randn((B, S, latent_dim), generator=generator, device=dev)
    drop = torch.rand((B,), generator=generator, device=dev) < p_uncond
    return CFMNoise(t=t, x0=x0, drop=drop)


def cfm_loss(params: dict, cfg: ModelConfig, batch: dict, sched: Scheduler, *,
             noise, p_uncond: float = 0.1, remat: bool = False) -> Tensor:
    """Conditional Flow Matching loss (paper eq. 56) over latent sequences.

    x1 = latent embedding of the data tokens (its gradient reaches
    ``flow.latent_embed``); x_t = sigma_t x0 + alpha_t x1; target velocity =
    sigma'_t x0 + alpha'_t x1; each row's conditioning tokens are zeroed
    where ``noise.drop`` is set. The mean squared error in f32. ``noise`` is
    a ``CFMNoise``, or a ``torch.Generator`` to draw one from
    (``draw_cfm_noise`` with ``p_uncond``); the reference draws from its rng
    argument. ``remat`` recomputes each layer in the backward.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    if isinstance(noise, torch.Generator):
        noise = draw_cfm_noise(noise, B, S, cfg.latent_dim, p_uncond, tokens.device)
    x1 = latent_targets(params, tokens).to(torch.float32)
    b = context.batch_axis()
    x0 = context.constrain(noise.x0, b, None, None)
    t = context.constrain(noise.t, b)
    tb = t[:, None, None]
    a, s = sched.alpha(tb), sched.sigma(tb)
    da, ds = sched.dalpha(tb), sched.dsigma(tb)
    x_t = s * x0 + a * x1
    target = ds * x0 + da * x1
    cond_tokens = torch.where(noise.drop[:, None], torch.zeros_like(tokens), tokens)
    v = velocity(params, cfg, t, x_t.to(torch.float32), {**batch, "tokens": cond_tokens},
                 remat=remat)
    return torch.mean((v.to(torch.float32) - target) ** 2)


# ---------------------------------------------------------------------------
# Decode: one token per call over a KV cache
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, slots: int, dtype=torch.bfloat16,
                      device="cuda", num_frames: int = 1500):
    """A KV cache of ``slots`` positions (dense, moe, vlm), the recurrent state
    (ssm: f32 whatever ``dtype``, and ``slots`` unused, as in the reference),
    both (hybrid: conv tails and one KV cache a shared-attention site in
    ``dtype``, the SSD state in f32), or the decoder's KV cache and a zeroed
    encoder memory of ``num_frames`` (encdec; the reference's default 1500
    whatever the config)."""
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, batch, device)
    if cfg.family == "hybrid":
        return mamba2.init_state(cfg, batch, slots, dtype, device)
    if cfg.family == "encdec":
        return whisper.init_state(cfg, batch, slots, num_frames, dtype,
                                  resolve_device(device))
    if cfg.family == "vlm":
        return vlm.init_state(cfg, batch, slots, dtype, resolve_device(device))
    return transformer.init_caches(cfg, batch, slots, dtype, resolve_device(device))


def init_paged_decode_state(cfg: ModelConfig, batch: int, num_pages: int,
                            page_size: int, blocks_per_slot: int,
                            dtype=torch.bfloat16, device="cuda"):
    """Paged decode state (``PagedKVCache``) for the KV-cache families."""
    if cfg.family not in PAGED_FAMILIES:
        raise TypeError(f"paged KV cache not supported for {cfg.family!r} "
                        f"(pageable families: {PAGED_FAMILIES})")
    return transformer.init_paged_caches(cfg, batch, num_pages, page_size,
                                         blocks_per_slot, dtype, resolve_device(device))


def decode_state_batch_axes(cfg: ModelConfig, paged: bool = False):
    """The BATCH axis of each state leaf (the axis indexed by sequence slot),
    in the state's own structure; slot serving resets rows through it.
    ``paged=True``: the page pool has no per-row axis and reads ``-1``; rows
    are isolated there by page ownership and the trash page, not by masks."""
    if paged and cfg.family in PAGED_FAMILIES:
        return PagedKVCache(k_pages=-1, v_pages=-1, block_table=0, index=0)
    if cfg.family == "ssm":
        return RWKVState(shift_tm=1, shift_cm=1, wkv=1, index=0)
    if cfg.family == "hybrid":
        return HybridState(conv=1, ssm=1, kv=1, vv=1, index=0)
    if cfg.family == "encdec":
        return EncDecState(k=1, v=1, memory=0, index=0)
    return KVCache(k=1, v=1, index=0)


def decode_apply(params: dict, cfg: ModelConfig, token: Tensor, state, *,
                 window: int = 0, paged_kernel: bool = False,
                 active: Optional[Tensor] = None):
    """One decode step; ``state`` is updated in place (``transformer.decode_step``
    for dense and vlm, ``moe.decode_step``, ``rwkv6.decode_step``, which ignores
    ``window`` and ``paged_kernel``, ``mamba2.decode_step``, which ignores
    ``paged_kernel``, or ``whisper.decode_step``, which ignores both, as the
    reference's does)."""
    if cfg.family == "ssm":
        return rwkv6.decode_step(params, cfg, token, state, active=active)
    if cfg.family == "hybrid":
        return mamba2.decode_step(params, cfg, token, state, window=window, active=active)
    if cfg.family == "moe":
        return moe.decode_step(params, cfg, token, state, window=window,
                               paged_kernel=paged_kernel, active=active)
    if cfg.family == "encdec":
        return whisper.decode_step(params, cfg, token, state, active=active)
    if cfg.family == "vlm":
        return vlm.decode_step(params, cfg, token, state, window=window,
                               paged_kernel=paged_kernel, active=active)
    return transformer.decode_step(params, cfg, token, state, window=window,
                                   paged_kernel=paged_kernel, active=active)
