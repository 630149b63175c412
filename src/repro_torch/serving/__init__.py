"""Serving: the flow samplers (``FlowSampler``, ``AnytimeFlowSampler``) and
the ``SolverZoo`` that hands them solver artifacts; the flow gateways
(``Gateway``, ``ContinuousGateway``) with shape tiers, SLO scheduling and
streaming; decode serving through ``DecodeGateway``; the fleet tier
(``FleetGateway``: per-host gateways behind one submit, HRW affinity
routing through ``FleetRouter``, work stealing through ``WorkStealer``,
graceful join and leave); and backbone placement on a serving mesh
(``sharded``, the ``mesh=`` argument of every gateway)."""
from repro_torch.serving.continuous import ContinuousGateway, ContinuousScheduler
from repro_torch.serving.decode import DecodeGateway, DecodeRequest, DecodeResponse
from repro_torch.serving.engine import (
    AnytimeFlowSampler,
    DecodeEngine,
    FlowSampler,
    SamplingParams,
    greedy_demo,
    nearest_budget,
    nearest_latent_tokens,
    sample_tokens,
)
from repro_torch.serving.fleet import FleetGateway, FleetRouter, WorkStealer
from repro_torch.serving.gateway import (
    BatchScheduler,
    DrainTimeout,
    Gateway,
    GatewayBase,
    GatewayStats,
    HostLoad,
    Request,
    RequestQueue,
    Response,
)
from repro_torch.serving.slo import (
    AdmissionRejected,
    DeadlineExceeded,
    PausedCarry,
    SLOConfig,
    urgency_key,
)
from repro_torch.serving.stream import ResponseStream, StreamChunk, StreamSink
from repro_torch.serving.tiers import ShapeLadder, TierOversize
from repro_torch.serving.zoo import SolverZoo, ZooStats

__all__ = ["AdmissionRejected", "AnytimeFlowSampler", "BatchScheduler",
           "ContinuousGateway", "ContinuousScheduler", "DeadlineExceeded",
           "DecodeEngine", "DecodeGateway", "DecodeRequest",
           "DecodeResponse", "DrainTimeout", "FleetGateway", "FleetRouter",
           "FlowSampler", "Gateway",
           "GatewayBase", "GatewayStats", "HostLoad", "PausedCarry",
           "Request", "RequestQueue", "Response", "ResponseStream",
           "SLOConfig", "SamplingParams", "ShapeLadder", "SolverZoo",
           "StreamChunk", "StreamSink", "TierOversize", "WorkStealer", "ZooStats",
           "greedy_demo", "nearest_budget", "nearest_latent_tokens",
           "sample_tokens", "urgency_key"]
