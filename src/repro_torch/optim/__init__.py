"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_update,
    adam_update_,
    adamw,
)
from repro_torch.optim.schedule import (
    constant_schedule,
    cosine_annealing,
    poly_decay,
    schedule_table,
    warmup_cosine,
)

__all__ = [
    "AdamState", "adam_init", "adam_update", "adam_update_", "adamw",
    "constant_schedule", "cosine_annealing", "poly_decay", "schedule_table",
    "warmup_cosine",
]
