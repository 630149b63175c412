"""InternVL2-26b backbone: an InternLM2-style dense LM over stubbed vision
patch embeddings [arXiv:2404.16821].

Port of ``repro.models.vlm``. The InternViT encoder is a stub, as in the
reference: the batch carries patch embeddings (B, n_patches, vit_dim) under
``"patches"``. The trainable MLP projector (vit_dim -> d_model, tanh-GELU)
is implemented, and the projected patches are prepended to the sequence as
a multimodal prefix (``models.model``'s flow path). The LM is the dense
family's (``transformer``): flash attention at 48 / 8 heads of 128 (G 6) in
flow and in ``lm_forward`` (logits over [patches; tokens]), the dense or
paged KV cache in decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context
from repro_torch.models import transformer
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


def init_vlm_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """The dense LM's params plus the projector, cast to the model dtype."""
    params = transformer.init_dense_params(generator, cfg, device)
    dtype = getattr(torch, cfg.dtype)
    params["projector"] = {
        "w1": dense_init(generator, cfg.frontend.embed_dim, cfg.d_model).to(dtype),
        "w2": dense_init(generator, cfg.d_model, cfg.d_model).to(dtype),
    }
    return params


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's numpy param tree (the dense
    tree plus ``projector``; ``transformer.params_from_jax``)."""
    expected = {"embed", "layers", "final_norm", "flow", "projector"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    return transformer.transfer_params(tree, expected, device, dtype)


def project_patches(params: dict, patches: Tensor) -> Tensor:
    """patches (B, P, vit_dim), cast to the projector's dtype -> (B, P, d_model)."""
    p = params["projector"]
    hidden = context.pin_batch(F.gelu(patches.to(p["w1"].dtype) @ p["w1"], approximate="tanh"),
                               model_last=True)
    return context.pin_batch(hidden @ p["w2"])


def lm_forward(params: dict, cfg: ModelConfig, tokens: Tensor, patches: Tensor,
               positions=None, *, window: int = 0, last_only: bool = False) -> Tensor:
    """Multimodal prefill: logits over [patch tokens; text tokens]."""
    return transformer.lm_forward(params, cfg, tokens, positions, window=window,
                                  extra_embeds=project_patches(params, patches),
                                  last_only=last_only)


def init_state(cfg: ModelConfig, batch: int, slots: int, dtype=torch.bfloat16,
               device="cuda"):
    return transformer.init_caches(cfg, batch, slots, dtype, device)


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, caches, **kw):
    """Text decode after the multimodal prefix is in the cache (the dense
    family's step; ``kw`` as ``transformer.decode_step`` takes them)."""
    return transformer.decode_step(params, cfg, token, caches, **kw)
