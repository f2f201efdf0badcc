"""Command-line entry points of the port: ``python -m
repro_torch.launch.query``, ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.ops``."""
