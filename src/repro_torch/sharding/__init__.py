"""Sharding rules of the port (``rules``): parameter, batch and cache
specs over a named mesh, and their DTensor placements."""
