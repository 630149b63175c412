"""Qwen3-MoE 235B-A22B — 128 experts, top-8, GQA + qk-norm
[hf:Qwen/Qwen3-30B-A3B scaled per pool spec]."""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CITATION = "hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE family model card)"


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
        rope_theta=1_000_000.0, qk_norm=True, sliding_window=8192,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.0, router_impl="scatter"),
        citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      capacity_factor=1.25, router_impl="scatter"),
        dtype="float32")
