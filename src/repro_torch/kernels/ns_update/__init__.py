"""NS solver update rule: CUDA kernel, plain version and dispatch."""
