"""Hand-written CUDA kernels for the H100 (sources in ``csrc/``), each beside
its plain PyTorch version (``ref.py``) and a dispatching wrapper (``ops.py``):
CPU tensors take the plain version, CUDA tensors launch the kernel or raise."""
