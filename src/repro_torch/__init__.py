"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100.

Same subpackage layout as ``src/repro`` (configs, core, solvers, kernels,
models, data, serving, launch), so every module has its twin at the same
path in the JAX reference. The port imports torch and numpy, never JAX or
``repro``.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when no card is present; the CPU runs only when asked for
(``device="cpu"``), which is how the tests hold the port against the JAX
package.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain CPU path")
    return dev
