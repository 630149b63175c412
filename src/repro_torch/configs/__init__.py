"""Architecture registry: --arch <id> resolves here.

``ARCHS`` lists the reference registry's ten architectures, all of which the
port runs; ``UNPORTED_ARCHS`` names none since the last two families
(whisper-medium's encdec and internvl2-26b's vlm) were ported.
"""
import dataclasses
import importlib

import torch

from repro_torch.configs.base import FrontendStub, ModelConfig, MoEConfig, SSMConfig

ARCHS = ("yi-6b", "phi3-medium-14b", "command-r-35b", "zamba2-2.7b", "yi-34b",
         "qwen3-moe-235b-a22b", "qwen3-moe-30b-a3b", "rwkv6-7b", "whisper-medium",
         "internvl2-26b")
UNPORTED_ARCHS: tuple = ()


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = _module(arch)
    return mod.smoke_config() if smoke else mod.config()


def for_device(cfg: ModelConfig, device) -> ModelConfig:
    """``cfg`` as ``device`` runs its flow path. The smoke configs' attention
    heads are 32 wide, narrower than every head dim the flash kernel is built
    for (``kernels.flash_attention.flash_attention.HEAD_DIMS``): on a CUDA
    device their heads widen to 64. Anything else, and every config on the
    CPU, is returned as it is."""
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    if (torch.device(device).type != "cuda" or cfg.family == "ssm"
            or cfg.resolved_head_dim in HEAD_DIMS):
        return cfg
    return dataclasses.replace(cfg, head_dim=min(HEAD_DIMS))


__all__ = ["ARCHS", "UNPORTED_ARCHS", "get_config", "for_device", "ModelConfig", "MoEConfig",
           "SSMConfig", "FrontendStub"]
