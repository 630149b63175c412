"""Phi-3-medium (14B) — dense, RoPE + SwiGLU + GQA [arXiv:2404.14219]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CITATION = "arXiv:2404.14219 (Phi-3 Technical Report)"


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, head_dim=128,
        rope_theta=10_000.0, sliding_window=8192, citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=320, n_heads=10, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=256, dtype="float32")
