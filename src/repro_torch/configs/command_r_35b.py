"""Command-R 35B — dense GQA, parallel attn+FFN block, no biases
[hf:CohereForAI/c4ai-command-r-v01]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CITATION = "hf:CohereForAI/c4ai-command-r-v01 (model card)"


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense", n_layers=40, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128,
        rope_theta=8_000_000.0, parallel_block=True, tie_embeddings=True,
        sliding_window=8192, citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=256, dtype="float32")
