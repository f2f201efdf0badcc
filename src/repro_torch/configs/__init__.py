"""Model and shape configurations: copies of ``src/repro/configs`` (the
ten archs' ``CONFIG`` and ``SMOKE_CONFIG``, ``SHAPES``, the registry)."""
