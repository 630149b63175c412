"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CITATION = "arXiv:2411.15242 (Zamba2 suite)"


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        hybrid_attn_every=6, sliding_window=8192,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
        citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=256, hybrid_attn_every=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
        dtype="float32")
