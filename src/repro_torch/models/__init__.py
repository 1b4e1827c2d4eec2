"""Dense decoder model of the port: config, layers, stack, registry."""
from .config import ModelConfig
from .registry import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
