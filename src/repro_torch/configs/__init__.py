"""Architecture registry: --arch <id> resolves here.

``ARCHS`` lists only the architectures the port can run; the other entries of
``repro.configs.ARCHS`` arrive with their model families (ROADMAP Queue A
item 10).
"""
import importlib

from repro_torch.configs.base import FrontendStub, ModelConfig, MoEConfig, SSMConfig

ARCHS = ("yi-6b",)


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = _module(arch)
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ARCHS", "get_config", "ModelConfig", "MoEConfig", "SSMConfig",
           "FrontendStub"]
