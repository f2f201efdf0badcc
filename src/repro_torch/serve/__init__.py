"""Learned-index query serving over sorted output: the port of
``repro.serve`` (index, query engine, scheduler, cache, router, server)."""
