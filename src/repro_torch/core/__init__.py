"""The port of ``repro.core``: model, partitioning, pipeline."""
