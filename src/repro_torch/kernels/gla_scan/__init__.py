"""Gated linear recurrence (RWKV6 / Mamba2): CUDA kernel, plain version and dispatch."""
