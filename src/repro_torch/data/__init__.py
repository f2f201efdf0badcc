"""Record generators and stripe helpers: the port of ``repro.data``."""
