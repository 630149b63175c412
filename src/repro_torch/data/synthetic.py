"""Deterministic synthetic data pipeline.

Port of ``repro.data.synthetic``. The token streams are drawn with numpy, as
in the reference, so for one seed the port's tokens are bit-identical to the
reference's (Zipfian unigram mixture + Markov bigram structure). Batches come
back as ``torch.long`` tensors on the requested device. A config with a
stub frontend (whisper's audio frames, InternVL2's vision patches) also gets
its embeddings, ``standard_normal((B, num_tokens, embed_dim)) * 0.05`` from
the same generator after the tokens, as f32 under ``"frames"`` or
``"patches"``: bit-equal to the reference's draw.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 64
    seed: int = 0


def _zipf_probs(vocab: int, alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


class SyntheticTokens:
    """Markov-modulated Zipf token stream (deterministic per seed)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        rng = np.random.default_rng(data.seed)
        v = cfg.vocab
        self.unigram = _zipf_probs(v)
        # a sparse "bigram boost": each token prefers a few successors
        self.succ = rng.integers(0, v, size=(min(v, 4096), 4))

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(self.data.seed * 100_003 + step)
        B, S = self.data.batch_size, self.data.seq_len
        v = self.cfg.vocab
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.choice(v, size=B, p=self.unigram)
        for s in range(1, S):
            prev = np.minimum(toks[:, s - 1], len(self.succ) - 1)
            use_bigram = rng.random(B) < 0.5
            bigram = self.succ[prev, rng.integers(0, 4, size=B)]
            unigram = rng.choice(v, size=B, p=self.unigram)
            toks[:, s] = np.where(use_bigram, bigram, unigram)
        out = {"tokens": torch.from_numpy(toks).to(self.device)}
        fe = self.cfg.frontend
        if fe is not None:
            emb = rng.standard_normal((B, fe.num_tokens, fe.embed_dim)) * 0.05
            key = "frames" if fe.kind == "audio_frames" else "patches"
            out[key] = torch.from_numpy(emb.astype(np.float32)).to(self.device)
        return out
