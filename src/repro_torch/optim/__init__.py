"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
from repro_torch.optim.adam import AdamState, adam_init, adam_update, adam_update_
from repro_torch.optim.schedule import (
    constant_schedule,
    cosine_annealing,
    poly_decay,
    warmup_cosine,
)

__all__ = [
    "AdamState", "adam_init", "adam_update", "adam_update_",
    "constant_schedule", "cosine_annealing", "poly_decay", "warmup_cosine",
]
