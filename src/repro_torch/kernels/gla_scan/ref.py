"""Plain PyTorch oracle of the gla_scan kernel: the step-by-step recurrence
(twin of the reference's ref.py, which re-exports its ``gla_recurrent``), so
the kernel is held against a form independent of its chunked arithmetic."""
from repro_torch.models.linear_scan import gla_recurrent as gla_ref  # noqa: F401
