from .base import (SHAPES, ArchConfig, ShapeConfig, cell_is_runnable,
                   get_config, input_specs, list_archs, reduced, register)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "cell_is_runnable",
           "get_config", "input_specs", "list_archs", "reduced", "register"]
