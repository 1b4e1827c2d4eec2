"""Serving entry points of the port: static `generate` and the
continuous-batching `Engine`."""
