"""InternVL2-26B — InternViT (stub) + InternLM2-style LM [arXiv:2404.16821]."""
import dataclasses
from repro_torch.configs.base import FrontendStub, ModelConfig

CITATION = "arXiv:2404.16821 (InternVL 1.5/2 family)"


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
        rope_theta=1_000_000.0, sliding_window=8192,
        frontend=FrontendStub(kind="vision_patches", num_tokens=256,
                              embed_dim=3200),
        citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=256,
        frontend=FrontendStub(kind="vision_patches", num_tokens=8, embed_dim=64),
        dtype="float32")
