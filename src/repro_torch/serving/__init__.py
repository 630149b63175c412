"""Serving: the flow samplers (``FlowSampler``, ``AnytimeFlowSampler``) and
the ``SolverZoo`` that hands them solver artifacts; the flow gateways
(``Gateway``, ``ContinuousGateway``) with shape tiers, SLO scheduling and
streaming; and decode serving through ``DecodeGateway``. Backbone sharding
and the fleet tier come with ROADMAP Queue A item 8."""
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
           "DecodeResponse", "DrainTimeout", "FlowSampler", "Gateway",
           "GatewayBase", "GatewayStats", "HostLoad", "PausedCarry",
           "Request", "RequestQueue", "Response", "ResponseStream",
           "SLOConfig", "SamplingParams", "ShapeLadder", "SolverZoo",
           "StreamChunk", "StreamSink", "TierOversize", "ZooStats",
           "greedy_demo", "nearest_budget", "nearest_latent_tokens",
           "sample_tokens", "urgency_key"]
