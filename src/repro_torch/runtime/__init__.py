"""Runtime control of the port's serving engine."""
