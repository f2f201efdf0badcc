"""PyTorch/CUDA port of the ELSAR learned external sort (the JAX package
``repro`` is its reference).  Layout mirrors ``repro``: ``core`` (the
sort pipeline), ``kernels`` (hand-written CUDA kernels for Hopper and
their plain PyTorch versions), ``data`` (record generators)."""
