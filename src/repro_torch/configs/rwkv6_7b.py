"""RWKV6-7B "Finch" — attention-free, data-dependent decay [arXiv:2404.05892]."""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CITATION = "arXiv:2404.05892 (Eagle and Finch: RWKV-5/6)"


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
        n_heads=64, n_kv_heads=64, d_ff=14336, vocab=65536,
        ssm=SSMConfig(chunk=64), citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab=256, ssm=SSMConfig(chunk=16), dtype="float32")
