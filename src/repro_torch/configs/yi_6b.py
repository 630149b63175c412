"""Yi-6B — llama-architecture dense LM with GQA [arXiv:2403.04652]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CITATION = "arXiv:2403.04652 (Yi: Open Foundation Models by 01.AI)"


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=4, d_ff=11008, vocab=64000, head_dim=128,
        rope_theta=5_000_000.0, sliding_window=8192, citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=256, dtype="float32")
