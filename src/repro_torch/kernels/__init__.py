"""CUDA kernels for Hopper (``csrc/``), their wrappers and plain PyTorch
versions: the port of ``repro.kernels``."""
