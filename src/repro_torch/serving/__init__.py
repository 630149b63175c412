"""Serving: the flow samplers (``FlowSampler``, ``AnytimeFlowSampler``) and
the ``SolverZoo`` that hands them solver artifacts, and decode serving
through ``DecodeGateway`` (the flow gateway tiers come with ROADMAP Queue A
item 7)."""
from repro_torch.serving.decode import DecodeGateway, DecodeRequest, DecodeResponse
from repro_torch.serving.engine import (
    AnytimeFlowSampler,
    DecodeEngine,
    FlowSampler,
    SamplingParams,
    greedy_demo,
    nearest_budget,
    nearest_latent_tokens,
)
from repro_torch.serving.slo import AdmissionRejected, DeadlineExceeded, SLOConfig
from repro_torch.serving.zoo import SolverZoo, ZooStats

__all__ = ["FlowSampler", "AnytimeFlowSampler", "SolverZoo", "ZooStats", "nearest_budget",
           "nearest_latent_tokens", "DecodeEngine", "SamplingParams", "greedy_demo", "DecodeGateway", "DecodeRequest",
           "DecodeResponse", "SLOConfig", "AdmissionRejected", "DeadlineExceeded"]
