"""Shape-tier ladder: one slot pool for heterogeneous multi-modal traffic.

The port's copy of ``repro.serving.tiers`` (numpy and torch; no JAX in the
reference either).

Every scheduling layer above the sampler groups work by a ``shape_key``
tuple — flush buckets (``BatchScheduler.plan``) and continuous trajectories
(``ContinuousScheduler.plan_start``/``plan_joins``). With exact shapes as the
key, an audio clip of 15 latent positions and one of 16 can never share a
flush batch, a trajectory slot, or a dispatch shape — heterogeneous traffic
fragments into per-shape puddles and the batching win evaporates.

A ``ShapeLadder`` fixes the key, not the schedulers: requests are padded
along their leading (sequence / resolution) axis up to the smallest
configured rung at SUBMIT time, so the ``shape_key`` every scheduler
already groups on IS the tier key, and one slot pool serves every shape
in a tier. The entry records its native shape; every settle path crops
the padded row back before it reaches the caller.

Bit-identity contract
---------------------
Tier padding extends the padded-batch contract from the BATCH axis to the
POSITION axis: pad positions are zeros, and positions must be independent
through the field for the crop to return exactly the direct sampler's
output at the native shape (the NS update itself is elementwise, so
independence of the field is the only requirement). That holds for
per-position fields (the analytic toy field) and for a causal backbone
(yi-6b's flow field: tail positions never reach earlier ones); a backbone
that mixes positions (full attention without masking) would need a
position mask, which is why tiering is strictly OPT-IN (``tiers=None``
keeps the exact-shape behaviour).

Samples with no position axis (``ndim < 2``, e.g. the toy's bare ``(d,)``
points) are never padded: each such shape is its own exact tier. Requests
LONGER than the top rung are rejected at submit with ``TierOversize``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


class TierOversize(ValueError):
    """The request's position axis exceeds the ladder's top rung. Raised
    at submit, before the request is ever queued or counted — the caller
    gets the configured rungs so the fix (raise the ladder, or shrink the
    request) is in the message."""

    def __init__(self, length: int, rungs: Sequence[int]):
        super().__init__(
            f"request has {length} positions but the tier ladder tops out "
            f"at {max(rungs)} (rungs={tuple(rungs)}); raise --tiers or "
            f"shorten the request")
        self.length = length
        self.rungs = tuple(rungs)


@dataclasses.dataclass(frozen=True)
class ShapeLadder:
    """Configured seq-length / resolution rungs, sorted ascending.

    ``rung(n)`` maps a native length to the smallest rung holding it;
    ``tier_shape(shape)`` maps a sample shape to its padded tier shape;
    ``request_key`` maps a request's (tokens, x0) shapes to the tier key
    (the reference's fleet router hashes it, so near-shapes home to the
    same host).
    """

    rungs: tuple

    def __post_init__(self):
        rungs = tuple(sorted(set(int(r) for r in self.rungs)))
        if not rungs:
            raise ValueError("ShapeLadder needs at least one rung")
        if rungs[0] < 1:
            raise ValueError(f"rungs must be positive, got {rungs}")
        object.__setattr__(self, "rungs", rungs)

    @classmethod
    def parse(cls, text: str) -> "ShapeLadder":
        """Build from the CLI form ``"8,16,32"`` (``serve.py --tiers``)."""
        try:
            rungs = tuple(int(tok) for tok in text.split(",") if tok.strip())
        except ValueError:
            raise ValueError(
                f"--tiers expects comma-separated ints, got {text!r}")
        return cls(rungs)

    def rung(self, length: int) -> int:
        """Smallest rung >= ``length``; ``TierOversize`` past the top."""
        for r in self.rungs:
            if r >= length:
                return r
        raise TierOversize(length, self.rungs)

    def rung_for(self, shape: Sequence[int]) -> Optional[int]:
        """The rung for a sample shape, or None when the shape has no
        position axis (``ndim < 2``: its own exact tier, never padded)."""
        if len(shape) < 2:
            return None
        return self.rung(shape[0])

    def tier_shape(self, shape: Sequence[int]) -> tuple:
        """The padded shape a sample of ``shape`` is served at."""
        shape = tuple(shape)
        r = self.rung_for(shape)
        return shape if r is None else (r,) + shape[1:]

    def request_key(self, tok_shape: Optional[tuple],
                    x0_shape: Optional[tuple]) -> tuple:
        """Tier the (tokens, x0) shape pair of a not-yet-submitted request.
        The rung comes from the x0 position axis when x0 is explicit, else
        from the token length (the gateway draws x0 as ``(len(tokens),
        latent_dim)``); both axes tier to the SAME rung so the key matches
        the submitted entry's padded ``shape_key``. Oversize falls back to
        the exact shapes — routing must not raise for a request submit()
        will reject anyway."""
        length = None
        if x0_shape is not None and len(x0_shape) >= 2:
            length = x0_shape[0]
        elif x0_shape is None and tok_shape:
            length = tok_shape[0]
        if length is None:
            return (tok_shape, x0_shape)
        try:
            r = self.rung(length)
        except TierOversize:
            return (tok_shape, x0_shape)
        tok = None if tok_shape is None else (r,) + tuple(tok_shape[1:])
        x0 = None if x0_shape is None else (r,) + tuple(x0_shape[1:])
        return (tok, x0)

    @staticmethod
    def label(shape: Sequence[int]) -> str:
        """Metric-label form of a tier shape (``(16, 2)`` -> ``"16x2"``)."""
        return "x".join(str(int(d)) for d in shape)


def pad_rows(arr, rung: int):
    """Zero-pad ``arr`` (a numpy array or a torch tensor) along its leading
    (position) axis up to ``rung`` — the position-axis twin of
    ``assemble_rows``' batch padding, and the single definition of the tier
    pad contract (zero positions, cropped back at settle). Returns ``arr``
    itself when it already has ``rung`` positions."""
    pad = rung - arr.shape[0]
    if pad <= 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
    arr = np.asarray(arr)
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


def crop_row(row, native_shape: Optional[tuple]):
    """Crop one settled row back to its native extent (no-op for untiered
    entries and exact-rung shapes). Every settle path — flush scatter,
    trajectory release, streaming partial — goes through this."""
    if native_shape is None or tuple(row.shape) == tuple(native_shape):
        return row
    return row[:native_shape[0]]
