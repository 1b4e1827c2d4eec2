"""Step builders of the port (forward parts of `repro.distributed`)."""
