"""Architecture registry: --arch <id> resolves here.

``ARCHS`` lists the reference registry's ten architectures, all of which the
port runs; ``UNPORTED_ARCHS`` names none since the last two families
(whisper-medium's encdec and internvl2-26b's vlm) were ported.
"""
import importlib

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


__all__ = ["ARCHS", "UNPORTED_ARCHS", "get_config", "ModelConfig", "MoEConfig", "SSMConfig",
           "FrontendStub"]
