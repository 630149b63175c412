"""Serving: the flow sampler (gateway tiers come with ROADMAP Queue A item 7)."""
from repro_torch.serving.engine import FlowSampler, nearest_budget, nearest_latent_tokens

__all__ = ["FlowSampler", "nearest_budget", "nearest_latent_tokens"]
