"""Model configurations of the port."""
from .base import (LONG_CTX_ARCHS, SHAPES, cell_applicable, get_config,
                   list_archs, reduce_config)

__all__ = ["LONG_CTX_ARCHS", "SHAPES", "cell_applicable", "get_config",
           "list_archs", "reduce_config"]
