"""Runtime of the port: the draft ladder controller, checkpoints and the
training supervisor."""
