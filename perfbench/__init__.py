"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``perfbench/run.py`` runs one cell of ``BENCHMARK.json`` once and prints
one JSON line.  Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package; the port is imported only by :mod:`perfbench.harness`.
"""
