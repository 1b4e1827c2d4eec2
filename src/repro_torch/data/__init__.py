"""Training data of the port (port of `repro.data`)."""
from .pipeline import DataConfig, make_pipeline  # noqa: F401
