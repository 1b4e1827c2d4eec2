"""Model configurations of the port."""
from .base import get_config, reduce_config

__all__ = ["get_config", "reduce_config"]
