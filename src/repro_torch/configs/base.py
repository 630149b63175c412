"""Config system: one dataclass describes every assigned architecture.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package). Every ``src/repro_torch/configs/<id>.py`` exports
``config()`` (the exact published configuration, cited) and
``smoke_config()`` (a reduced same-family variant for CPU tests: <=2 layers,
d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_impl: str = "scatter"   # "scatter" (memory-lean) | "onehot" (reference)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64              # Mamba2 state size per head-channel
    d_conv: int = 4                # causal conv width
    expand: int = 2                # d_inner = expand * d_model
    head_dim: int = 64             # Mamba2 head dim
    chunk: int = 64                # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Stubbed modality frontend: input_specs() provides these embeddings."""

    kind: str                      # "audio_frames" | "vision_patches"
    num_tokens: int                # e.g. 1500 mel frames / 256 patches
    embed_dim: int                 # dim of provided embeddings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    parallel_block: bool = False   # command-r style parallel attn+FFN
    qk_norm: bool = False
    sliding_window: int = 0        # 0 = full attention; >0 enables long_500k decode
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared attention block applied every k SSM layers
    hybrid_attn_every: int = 0
    # enc-dec (whisper): encoder depth + frontend stub
    n_encoder_layers: int = 0
    frontend: Optional[FrontendStub] = None
    # flow mode (the paper's generative substrate)
    latent_dim: int = 64
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.family == "moe":
            assert self.moe is not None
            mlp = 3 * d * self.moe.d_expert * self.moe.num_experts + d * self.moe.num_experts
        else:
            mlp = 3 * d * ff
        if self.family == "ssm":      # rwkv6: time-mix + channel-mix
            attn = 4 * d * d + d * d  # r,k,v,g,o projections (approx)
            mlp = 2 * d * ff + ff * 0 + d * ff
        if self.family == "hybrid":
            assert self.ssm is not None
            di = self.ssm.expand * d
            attn = 0  # shared block counted once below
            mlp = 2 * d * di + di * d + di * d  # in/out/gate approx
        block = attn + mlp + 2 * d
        total = v * d + L * block + d
        if self.family == "hybrid":
            total += 4 * d * d + 3 * d * ff  # the single shared attention block
        if not self.tie_embeddings:
            total += v * d
        return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: parameters touched per token (top-k of experts)."""
    if cfg.family != "moe" or cfg.moe is None:
        return cfg.param_count()
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * cfg.n_heads + 2 * d * hd * cfg.n_kv_heads + hd * cfg.n_heads * d
    mlp_active = 3 * d * cfg.moe.d_expert * cfg.moe.top_k
    total = cfg.vocab * d * 2 + L * (attn + mlp_active + 2 * d) + d
    return int(total)
