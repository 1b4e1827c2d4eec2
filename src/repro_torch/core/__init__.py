"""Numerics, dispatch and KV-cache layers of the port."""
