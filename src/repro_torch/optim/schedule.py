"""Learning-rate schedules used in the paper's training recipes.

Port of ``repro.optim.schedule``. Class-conditional BNS: lr 5e-4 with
polynomial decay; T2I/audio BNS: lr 1e-4 with cosine annealing; backbone
pretraining: constant or poly-decay + warmup.

Each schedule is a function of the step (a Python int or a tensor) that
returns a 0-d float32 tensor, on the step's device when the step is a tensor,
computed in f32 as the reference computes it. ``schedule_table`` evaluates
one at every step up front on the host, for a training program that gathers
its rate on the device at Adam's counted step (the card's own f32 arithmetic
rounds an ulp differently from the host's).
"""
from __future__ import annotations

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=_step(step).device)


def poly_decay(lr: float, total_steps: int, power: float = 1.0, end_lr: float = 0.0):
    def fn(step):
        frac = torch.clamp(_step(step).to(torch.float32) / total_steps, 0.0, 1.0)
        return (lr - end_lr) * (1.0 - frac) ** power + end_lr

    return fn


def cosine_annealing(lr: float, total_steps: int, end_lr: float = 0.0):
    def fn(step):
        frac = torch.clamp(_step(step).to(torch.float32) / total_steps, 0.0, 1.0)
        return end_lr + 0.5 * (lr - end_lr) * (1.0 + torch.cos(torch.pi * frac))

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, end_lr: float = 0.0):
    cos = cosine_annealing(lr, max(total_steps - warmup_steps, 1), end_lr)

    def fn(step):
        step = _step(step)
        warm = lr * step.to(torch.float32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn


def schedule_table(lr_fn, steps: int, device) -> torch.Tensor:
    """``lr_fn(i)`` for i in 0..steps-1, computed on the host, as one f32
    tensor on ``device``."""
    return torch.tensor([float(lr_fn(i)) for i in range(steps)], dtype=torch.float32,
                        device=device)
