"""Token sampling and speculative decoding of the port."""
from .sampler import SamplerConfig
from .spec_decode import SpecConfig

__all__ = ["SamplerConfig", "SpecConfig"]
