"""Serving engines.

Port of ``repro.serving.engine``:

``FlowSampler`` — the paper's product: batched sampling of a flow model with
an NS solver (Algorithm 1), built from any NS solver or from a loaded
``SolverArtifact`` (``from_artifact``). Each request batch costs exactly
``n`` backbone forwards, and every solver step's update runs the
``ns_update`` kernel on the card (its plain version on the CPU).

``AnytimeFlowSampler`` — multi-NFE serving from ONE anytime artifact.
Budget routing: ``sample(batch, generator, budget=m)`` with m served runs
the extracted m-step early-exit solver (``core.anytime.extract_ns``, made
once a budget and kept): exactly m backbone forwards. An m not served goes
to the nearest served budget (ties to the cheaper), or raises under
``strict``. ``sample_all`` runs the one shared trajectory to the top budget
and returns every exit; ``carry_start``/``carry_extend`` advance it leg by
leg (``serving.continuous.ContinuousGateway``'s surface).

Program caches: where the reference compiles one jit program a budget, a
leg, a decode step or a prefill width, each engine here keeps a
``serving.programs.ProgramCache``: on the card every program is captured
once per key as a CUDA graph and replayed (``programs.disabled()`` runs
eagerly, as ``jax.disable_jit`` does); on the CPU the engines run eagerly.
Noise, Gumbel draws and host-to-device copies happen before a replay, the
tokens' copy to the host after it.

``DecodeEngine`` — batched autoregressive decode over a KV cache (the ssm
family: its recurrent state, where ``page_size`` is a no-op; the hybrid
family: both, and ``page_size`` is refused): ``greedy``
(a Python loop where the reference scans) and the slot API
(``init_slot_state`` / ``step_slots`` / ``prefill_slots`` / ``reset_slots``)
that ``serving.decode.DecodeGateway`` serves from. ``page_size > 0`` pages
the cache (``PagedKVCache``), and ``paged_kernel`` attends through the
paged-attention kernel. ``SamplingParams`` / ``sample_tokens`` add
temperature / top-k / top-p sampling beside greedy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import anytime as anytime_mod
from repro_torch.core import ns_solver
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.schedulers import Scheduler
from repro_torch.models import model as M
from repro_torch.serving.programs import ProgramCache

Tensor = torch.Tensor


def nearest_budget(budgets, m: int, strict: bool = False) -> int:
    """The budget-routing rule: an exact match passes through; otherwise the
    nearest served budget (ties break to the smaller — fewer backbone
    forwards), or ``ValueError`` under ``strict``."""
    if m in budgets:
        return m
    if strict:
        raise ValueError(f"budget {m} not served; have {tuple(budgets)}")
    return min(budgets, key=lambda b: (abs(b - m), b))


def nearest_latent_tokens(params: dict, latents: Tensor) -> Tensor:
    """Decode sampled latents to tokens by nearest latent embedding."""
    table = params["flow"]["latent_embed"].to(torch.float32)
    lat = latents.to(torch.float32)
    d2 = (torch.sum(lat ** 2, -1, keepdim=True)
          - 2.0 * lat @ table.T
          + torch.sum(table ** 2, -1))
    return torch.argmin(d2, dim=-1)


@dataclasses.dataclass
class FlowSampler:
    """A fixed-NFE sampling session on the device that holds ``params``."""

    params: dict
    cfg: ModelConfig
    sched: Scheduler
    solver: NSParams
    cfg_scale: float = 0.0

    def __post_init__(self):
        self.device = self.params["final_norm"].device
        self.solver = self.solver.to(self.device)
        self.programs = ProgramCache(self.device)

    @classmethod
    def from_artifact(cls, artifact, *, params: dict, cfg: ModelConfig,
                      sched: Scheduler, budget: Optional[int] = None) -> "FlowSampler":
        """Serving session from a loaded ``repro_torch.solvers.SolverArtifact``.

        The artifact carries the solver and the CFG scale it was distilled
        under; the backbone (params/cfg/sched) comes from the launcher.
        ``budget`` selects one early exit of an anytime artifact (required
        there — ``AnytimeFlowSampler`` serves them all)."""
        if budget is None and artifact.kind == "anytime":
            raise TypeError(
                "anytime artifacts serve several budgets; pass budget=m for "
                "a fixed-NFE session or use AnytimeFlowSampler.from_artifact")
        solver = (artifact.ns_params if budget is None
                  else artifact.ns_at_budget(budget))
        return cls(params=params, cfg=cfg, sched=sched, solver=solver,
                   cfg_scale=artifact.spec.cfg_scale)

    def _sample(self, batch: Optional[dict], x0: Tensor) -> Tensor:
        """One program per (budget, x0's shape, conditioning or not): the
        reference's jitted ``_sample``. The graph reads the solver's
        tensors where they lie, so their addresses are part of the key."""
        solver = self.solver

        def run(x0, *cond):
            return ns_solver.ns_sample(solver, _field(self, cond).fn, x0)

        key = ("sample", solver.n, self.cfg_scale, tuple(p.data_ptr() for p in solver))
        with torch.no_grad():
            return self.programs(key, run, (x0,) + _cond(batch, self.device))

    # -- budget protocol: a fixed-NFE session serves exactly one budget. ----

    @property
    def budgets(self) -> tuple[int, ...]:
        return (self.solver.n,)

    def resolve_budget(self, m: int, strict: bool = False) -> int:
        """One served budget: exact match or (with ``strict``) rejection."""
        if m != self.solver.n and strict:
            raise ValueError(f"budget {m} not served; have {self.budgets}")
        return self.solver.n

    def sample_from(self, batch: Optional[dict], x0, budget: Optional[int] = None) -> Tensor:
        """Integrate given noise ``x0`` (a tensor or numpy array; this
        session's one budget)."""
        if budget is not None and budget != self.solver.n:
            raise ValueError(f"budget {budget} not served; have {self.budgets}")
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        return self._sample(batch, x0)

    def sample(self, batch: dict, generator: torch.Generator) -> Tensor:
        """Generate latent sequences conditioned on ``batch`` tokens, from
        noise drawn with ``generator`` (which lives on the sampler's device).

        The latent length equals the conditioning token length — the backbone
        adds conditioning embeddings position-wise, so they cannot differ.
        """
        B, S = batch["tokens"].shape
        x0 = torch.randn((B, S, self.cfg.latent_dim), generator=generator,
                         dtype=torch.float32, device=self.device)
        return self._sample(batch, x0)

    def nearest_tokens(self, latents: Tensor) -> Tensor:
        """Decode sampled latents to tokens by nearest latent embedding."""
        return nearest_latent_tokens(self.params, latents)


@dataclasses.dataclass
class AnytimeFlowSampler:
    """Budget-aware serving session over ONE anytime solver, on the device
    that holds ``params`` (routing contract: module docstring)."""

    params: dict
    cfg: ModelConfig
    sched: Scheduler
    anytime: anytime_mod.AnytimeParams
    budgets: tuple[int, ...]
    cfg_scale: float = 0.0

    def __post_init__(self):
        self.budgets = tuple(sorted(self.budgets))
        self.device = self.params["final_norm"].device
        self.anytime = anytime_mod.AnytimeParams(*(p.to(self.device) for p in self.anytime))
        self._per_budget: dict[int, NSParams] = {}
        self.programs = ProgramCache(self.device)

    @classmethod
    def from_artifact(cls, artifact, *, params: dict, cfg: ModelConfig,
                      sched: Scheduler) -> "AnytimeFlowSampler":
        """Serving session from a loaded anytime ``SolverArtifact``."""
        if artifact.kind != "anytime":
            raise TypeError(f"{artifact.kind!r} artifacts serve one budget; "
                            "use FlowSampler.from_artifact")
        return cls(params=params, cfg=cfg, sched=sched, anytime=artifact.params,
                   budgets=artifact.budgets, cfg_scale=artifact.spec.cfg_scale)

    def _key(self, *static) -> tuple:
        """A program key: ``static`` plus what every program here depends
        on (the CFG scale, the anytime solver's tensors by address)."""
        return static + (self.cfg_scale, tuple(p.data_ptr() for p in self.anytime))

    def _noise(self, batch: dict, generator: torch.Generator) -> Tensor:
        B, S = batch["tokens"].shape
        return torch.randn((B, S, self.cfg.latent_dim), generator=generator,
                           dtype=torch.float32, device=self.device)

    def _x0(self, x0) -> Tensor:
        return torch.as_tensor(x0, dtype=torch.float32).to(self.device)

    def resolve_budget(self, m: int, strict: bool = False) -> int:
        """Route a requested NFE to a served budget (nearest; ties cheaper)."""
        return nearest_budget(self.budgets, m, strict)

    def ns_at_budget(self, m: int) -> NSParams:
        """The extracted m-step solver, made once a budget (raises on an
        unserved budget)."""
        ns = self._per_budget.get(m)
        if ns is None:
            ns = self._per_budget[m] = anytime_mod.extract_ns(self.anytime, self.budgets, m)
        return ns

    def sample_from(self, batch: Optional[dict], x0, budget: int) -> Tensor:
        """Integrate given noise ``x0`` at exactly ``budget`` NFE."""
        ns = self.ns_at_budget(budget)

        def run(x0, *cond):
            return ns_solver.ns_sample(ns, _field(self, cond).fn, x0)

        with torch.no_grad():
            return self.programs(self._key("budget", budget), run,
                                 (self._x0(x0),) + _cond(batch, self.device))

    def sample(self, batch: dict, generator: torch.Generator, budget: int,
               strict: bool = False) -> Tensor:
        """Latents for ``batch`` at the requested NFE budget, from noise drawn
        with ``generator`` (on the sampler's device)."""
        budget = self.resolve_budget(budget, strict=strict)
        return self.sample_from(batch, self._noise(batch, generator), budget)

    def sample_all_from(self, batch: Optional[dict], x0) -> dict[int, Tensor]:
        """One shared trajectory from ``x0``; every budget's output, at
        max(budgets) forwards in all."""
        def run(x0, *cond):
            return anytime_mod.anytime_sample(self.anytime, self.budgets,
                                              _field(self, cond).fn, x0)

        with torch.no_grad():
            return self.programs(self._key("all"), run,
                                 (self._x0(x0),) + _cond(batch, self.device))

    def sample_all(self, batch: dict, generator: torch.Generator) -> dict[int, Tensor]:
        return self.sample_all_from(batch, self._noise(batch, generator))

    # -- carry protocol (continuous batching: serving.continuous) ------------

    def carry_start(self, batch: Optional[dict], x0) -> anytime_mod.AnytimeCarry:
        """A fresh shared-trajectory carry over ``x0`` (no forwards spent)."""
        return anytime_mod.anytime_carry(self.anytime, self.budgets, self._x0(x0))

    def carry_extend(self, batch: Optional[dict], carry: anytime_mod.AnytimeCarry,
                     stop: int) -> tuple[anytime_mod.AnytimeCarry, dict[int, Tensor]]:
        """Advance the shared trajectory to ``stop`` evals: the new carry plus
        the early-exit outputs crossed on the way, at exactly
        ``stop - carry.step`` backbone forwards. Row i of ``exits[k]`` is the
        sample a budget-k request with row i's noise gets from
        ``sample_from`` (the join invariant of ``anytime_extend``).

        One program per (start, stop, shapes): the carry's x0, U and x go in
        as inputs; the new U and x and every exit come out as copies, so a
        caller may keep (or clone) them across later legs."""
        start = carry.step

        def run(x0, U, x, *cond):
            new, outs = anytime_mod.anytime_extend(
                self.anytime, self.budgets, _field(self, cond).fn,
                anytime_mod.AnytimeCarry(x0=x0, U=U, x=x, step=start), stop)
            return new.U, new.x, outs

        with torch.no_grad():
            U, x, outs = self.programs(self._key("leg", start, stop), run,
                                       (carry.x0, carry.U, carry.x)
                                       + _cond(batch, self.device))
        return anytime_mod.AnytimeCarry(x0=carry.x0, U=U, x=x, step=stop), outs

    def nearest_tokens(self, latents: Tensor) -> Tensor:
        """Decode sampled latents to tokens by nearest latent embedding."""
        return nearest_latent_tokens(self.params, latents)


_COND_KEYS = ("tokens", "frames", "patches")   # what the backbones read of a batch


def _cond(batch: Optional[dict], device) -> tuple:
    """The batch's conditioning on ``device``: its tokens and a stub
    frontend's frames or patches, in ``_COND_KEYS`` order, None where the
    batch has none (all None: unconditional)."""
    return tuple(None if batch is None or batch.get(k) is None
                 else torch.as_tensor(batch[k]).to(device) for k in _COND_KEYS)


def _field(sampler, cond: tuple):
    """The sampler's velocity field conditioned on ``cond`` (``_cond``'s)."""
    batch = {k: v for k, v in zip(_COND_KEYS, cond) if v is not None} or None
    return M.velocity_field(sampler.params, sampler.cfg, sampler.sched, batch,
                            cfg_scale=sampler.cfg_scale)


# ---------------------------------------------------------------------------
# Sampling (temperature / top-k / top-p beside greedy)
# ---------------------------------------------------------------------------

_NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data`` (a splitmix64 round over their
    mix, cut to 63 bits for ``torch.Generator.manual_seed``): the port's twin
    of ``jax.random.fold_in``. The reference's threefry bits cannot be
    reproduced in torch; this keeps their property that a draw depends only
    on the seeds folded into it."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature == 0`` is exact greedy
    (argmax); ``top_k == 0`` and ``top_p == 1.0`` disable those filters.
    Determinism contract: given the gateway's base seed, a request's tokens
    depend only on (base seed, request uid, step)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


class SlotSampling(NamedTuple):
    """Per-slot sampling state for the sampled step (host numpy arrays).
    ``seeds`` are per-SEQUENCE seeds (base seed folded with the request uid);
    ``counts`` is each row's emitted-token count, folded in per step."""

    seeds: np.ndarray    # (slots,) uint64 per-sequence seeds
    counts: np.ndarray   # (slots,) int32 tokens emitted so far
    temps: np.ndarray    # (slots,) f32 temperature (0 = greedy)
    top_ks: np.ndarray   # (slots,) int32 top-k cutoff (0 = off)
    top_ps: np.ndarray   # (slots,) f32 top-p cutoff (1.0 = off)


def gumbel_noise(seeds, counts, temps, vocab: int, device) -> torch.Tensor:
    """(B, vocab) f32 Gumbel draws: row i from a generator seeded with
    ``fold_in(seeds[i], counts[i])``; greedy rows (temperature 0) get zeros."""
    out = torch.zeros((len(seeds), vocab), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for i, (seed, count, temp) in enumerate(zip(seeds, counts, temps)):
        if temp > 0:
            gen = torch.Generator(device=device).manual_seed(fold_in(int(seed), int(count)))
            u = torch.rand((vocab,), generator=gen, device=device).clamp_(min=tiny)
            out[i] = -torch.log(-torch.log(u))
    return out


def filter_logits(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits with everything outside each row's top-k
    and top-p set to -1e30. Both filters run on the descending-sorted
    logits; the exclusive cumsum keeps the top-1 token always."""
    V = logits.shape[-1]
    scaled = logits.to(torch.float32) / temps.clamp(min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks, V).clamp(1, V).long()
    kth = torch.take_along_dim(sorted_desc, (k - 1)[:, None], dim=-1)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    in_nucleus = (cum - probs) < top_ps[:, None]
    pth = torch.where(in_nucleus, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    cutoff = torch.maximum(kth, pth)
    return torch.where(scaled >= cutoff, scaled, _NEG_INF)


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row sampling with given Gumbel noise (B, V): temperature scale,
    top-k and top-p truncation, Gumbel-max draw; rows with ``temps == 0``
    take the exact argmax. The noise is an argument, so the filter can be
    held against the reference fed the reference's own draws."""
    greedy = torch.argmax(logits.to(torch.float32), dim=-1)
    masked = filter_logits(logits, temps, top_ks, top_ps)
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


@dataclasses.dataclass
class DecodeEngine:
    """Batched autoregressive decode over a KV cache, on ``params``' device.

    * ``greedy(prompt, state, num_steps)`` — run-to-completion batched greedy
      decode, one ``decode_apply`` per token: the reference's ``lax.scan``
      becomes ``num_steps`` replays of the one-step program that ``step``
      also runs.
    * slot serving — ``init_slot_state`` builds a fixed-slot state whose rows
      are INDEPENDENT sequences at their own positions (per-row ``index``);
      ``step_slots`` advances only the rows of the active mask;
      ``prefill_slots`` feeds prompt chunks teacher-forced, one
      ``decode_apply`` per column under the same row mask; ``reset_slots``
      zeroes freed rows. State is updated IN PLACE and returned: a dense
      cache only in the advanced rows (the others keep every bit), a paged
      pool unconditionally, as the reference's is (page ownership and the
      trash page 0 isolate rows; ``reset_slots`` leaves the pool alone and
      zeroes the row's block table). Every leaf keeps its tensor, the
      positions and ``with_block_table``'s table included, so the programs
      captured over a state (keyed by its leaves' addresses) stay valid.

    Programs (``serving.programs``): one a (slots, state) for ``step_slots``
    greedy and one sampled, one a (width, slots, state) for
    ``prefill_slots``, one a (batch, state) for ``step`` and ``greedy``.

    ``page_size > 0`` pages the cache; ``paged_kernel`` routes paged
    attention through the CUDA kernel (its plain version on the CPU).
    """

    params: dict
    cfg: ModelConfig
    window: int = 0
    page_size: int = 0          # > 0: paged KV cache
    paged_kernel: bool = False  # paged attention through the kernel

    #: gateways probe this before routing sampled requests
    supports_sampling = True

    def __post_init__(self):
        if self.page_size:
            if self.window:
                raise ValueError(
                    "paged KV cache is incompatible with sliding-window "
                    "decode (the ring buffer already bounds resident KV)")
            if self.cfg.family not in M.PAGED_FAMILIES + ("ssm",):
                raise TypeError(
                    f"page_size set but family {self.cfg.family!r} has no "
                    f"pageable KV state (pageable: {M.PAGED_FAMILIES}; "
                    "ssm accepted as a no-op)")
        self.device = self.params["final_norm"].device
        self._axes = M.decode_state_batch_axes(self.cfg, paged=self.paged)
        self.programs = ProgramCache(self.device)

    @property
    def paged(self) -> bool:
        """True when slot state is a ``PagedKVCache``."""
        return self.page_size > 0 and self.cfg.family in M.PAGED_FAMILIES

    @property
    def seq_capacity_bounded(self) -> bool:
        """True when decode positions must fit the cache's physical slots:
        non-windowed KV caches clamp writes to the last slot past capacity."""
        return self.window == 0 and self.cfg.family != "ssm"

    def _on_device(self, x, dtype=None) -> Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _apply(self, token, state, active=None):
        return M.decode_apply(self.params, self.cfg, token, state, window=self.window,
                              paged_kernel=self.paged_kernel, active=active)

    def init_state(self, batch: int, slots: int, dtype=torch.float32):
        return M.init_decode_state(self.cfg, batch, slots, dtype, self.device)

    def _one_step(self, token: Tensor, state) -> tuple[Tensor, Tensor]:
        """(logits, greedy next token) of one step, through the program of
        ``step`` and ``greedy``."""
        def run(token):
            logits, _ = self._apply(token, state)
            return logits, torch.argmax(logits, dim=-1).to(torch.int32)

        with torch.no_grad():
            return self.programs(("step",), run, (token,), tuple(state))

    def step(self, token, state):
        """One batched decode step: token (B,) -> (logits (B, V), state)."""
        return self._one_step(self._on_device(token), state)[0], state

    def greedy(self, prompt, state, num_steps: int):
        """prompt: (B,) last prompt token. Returns ((B, num_steps) int32
        tokens on the device, state)."""
        token = self._on_device(prompt)
        out = []
        for _ in range(num_steps):
            token = self._one_step(token, state)[1]
            out.append(token)
        return torch.stack(out, dim=1), state

    # -- slot serving (decode-side continuous batching) ----------------------

    def init_slot_state(self, slots: int, cache_slots: int, dtype=torch.float32,
                        total_pages: Optional[int] = None):
        """Fixed-slot batched decode state with PER-ROW positions. Paged
        engines return a ``PagedKVCache``: a shared pool of ``total_pages``
        pages (default: the trash page 0 plus every slot at full
        ``cache_slots`` residency) and an all-zero block table awaiting the
        gateway's allocator. ``cache_slots`` must be a multiple of
        ``page_size``."""
        if self.paged:
            ps = self.page_size
            if cache_slots % ps:
                raise ValueError(f"cache_slots ({cache_slots}) must be a multiple of "
                                 f"page_size ({ps})")
            blocks = cache_slots // ps
            pages = (1 + slots * blocks) if total_pages is None else total_pages
            if pages < 2:
                raise ValueError("total_pages must be >= 2 (page 0 is the "
                                 "reserved trash page)")
            return M.init_paged_decode_state(self.cfg, slots, pages, ps, blocks, dtype,
                                             self.device)
        state = self.init_state(slots, cache_slots, dtype)
        return state._replace(index=torch.zeros((slots,), dtype=torch.int32,
                                                device=self.device))

    def step_slots(self, token, state, active, sampling: Optional[SlotSampling] = None):
        """One write-masked decode step over the slot batch.

        ``token`` (slots,) feeds each row; rows where ``active`` is False
        flow through the backbone (fixed batch shape) but keep their state
        rows and positions. Returns (next token (slots,) int32 on the host,
        state): greedy argmax, or per-row draws when ``sampling`` is given
        (temperature-0 rows stay exact greedy). Bringing the tokens to the
        host waits for the step, so a caller's clock around the call
        covers the device work. The Gumbel noise is drawn before the
        program runs; only the filter and the draw run inside it."""
        inputs = (self._on_device(token), self._on_device(active, torch.bool))
        if sampling is None:
            def run(token, active):
                logits, _ = self._apply(token, state, active)
                return torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            inputs += (gumbel_noise(sampling.seeds, sampling.counts, sampling.temps,
                                    self.cfg.vocab, self.device),
                       self._on_device(sampling.temps, torch.float32),
                       self._on_device(sampling.top_ks, torch.int64),
                       self._on_device(sampling.top_ps, torch.float32))

            def run(token, active, noise, temps, top_ks, top_ps):
                logits, _ = self._apply(token, state, active)
                return sample_tokens(logits, noise, temps, top_ks, top_ps)
        with torch.no_grad():
            toks = self.programs(("step_slots", sampling is not None), run, inputs,
                                 tuple(state))
        if type(toks) is not torch.Tensor and hasattr(toks, "full_tensor"):
            toks = toks.full_tensor()      # the mesh path's DTensor, gathered
        return toks.cpu(), state

    def prefill_slots(self, tokens, lengths, state, mask):
        """Batched chunked prefill: feed ``tokens`` (slots, C) teacher-forced
        into the rows where ``mask`` is True, row i consuming its first
        ``lengths[i]`` columns (the rest are padding): one ``decode_apply``
        per column, the rows with ``mask & (column < length)`` advancing, as
        the reference's scan body does. Logits are discarded. The (C, slots)
        column masks are made on the host and copied once. On the card the
        call waits for its work before returning, so the caller's clock
        around it covers the device time."""
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths)
        cols = np.asarray(mask, bool)[None, :] & (np.arange(tokens.shape[1])[:, None]
                                                  < lengths[None, :])

        def run(tok, cols):
            for t in range(tok.shape[1]):
                self._apply(tok[:, t], state, cols[t])

        with torch.no_grad():
            self.programs(("prefill",), run,
                          (self._on_device(tokens), self._on_device(cols)), tuple(state))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state

    def reset_slots(self, state, free):
        """Zero, in place, the rows where ``free`` is True (a fresh row at
        position 0). Paged: the rows' block tables (-> trash page 0) and
        positions; the shared pool is left alone."""
        free = self._on_device(free, torch.bool)
        for leaf, ax in zip(state, self._axes):
            if ax == -1:
                continue
            shape = [1] * leaf.dim()
            shape[ax] = free.shape[0]
            leaf.masked_fill_(free.reshape(shape), 0)
        return state

    def with_block_table(self, state, table):
        """Copy the gateway allocator's host-side block table (paged engines
        only), (slots, blocks_per_slot) page ids, into the state's own."""
        table = torch.as_tensor(np.asarray(table), dtype=torch.int32)
        if table.shape != state.block_table.shape:
            raise ValueError(f"block table of shape {tuple(table.shape)}, the state's "
                             f"is {tuple(state.block_table.shape)}")
        state.block_table.copy_(table)
        return state


def greedy_demo(engine: DecodeEngine, batch: int, steps: int, cache_slots: int,
                prompt=None) -> tuple[Tensor, float]:
    """Solo-decode demo loop (``launch/serve.py --mode decode`` without the
    gateway): fresh dense state, ``steps`` greedy tokens from ``prompt``
    (default all zeros); returns (tokens (batch, steps), ms per token, read
    after the device has finished)."""
    state = engine.init_state(batch, cache_slots)
    if prompt is None:
        prompt = torch.zeros((batch,), dtype=torch.int32, device=engine.device)
    t0 = time.perf_counter()
    tokens, _ = engine.greedy(prompt, state, steps)
    tokens = tokens.cpu()
    return tokens, (time.perf_counter() - t0) / steps * 1e3
