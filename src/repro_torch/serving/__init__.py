"""Serving: the flow sampler, and decode serving through ``DecodeGateway``
(the flow gateway tiers come with ROADMAP Queue A item 7)."""
from repro_torch.serving.decode import DecodeGateway, DecodeRequest, DecodeResponse
from repro_torch.serving.engine import (
    DecodeEngine,
    FlowSampler,
    SamplingParams,
    greedy_demo,
    nearest_budget,
    nearest_latent_tokens,
)
from repro_torch.serving.slo import AdmissionRejected, DeadlineExceeded, SLOConfig

__all__ = ["FlowSampler", "nearest_budget", "nearest_latent_tokens", "DecodeEngine",
           "SamplingParams", "greedy_demo", "DecodeGateway", "DecodeRequest",
           "DecodeResponse", "SLOConfig", "AdmissionRejected", "DeadlineExceeded"]
