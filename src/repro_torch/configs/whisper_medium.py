"""Whisper-medium — enc-dec audio backbone; conv/mel frontend stubbed
[arXiv:2212.04356]."""
import dataclasses
from repro_torch.configs.base import FrontendStub, ModelConfig

CITATION = "arXiv:2212.04356 (Whisper: Robust Speech Recognition)"


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
        n_encoder_layers=24, tie_embeddings=True,
        frontend=FrontendStub(kind="audio_frames", num_tokens=1500,
                              embed_dim=1024),
        citation=CITATION)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=256,
        frontend=FrontendStub(kind="audio_frames", num_tokens=16, embed_dim=128),
        dtype="float32")
