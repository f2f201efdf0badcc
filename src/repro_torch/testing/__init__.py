"""Test helpers of the port (copy of ``src/repro/testing``)."""
