from .base import ArchConfig, get_config, list_archs, reduced, register

__all__ = ["ArchConfig", "get_config", "list_archs", "reduced", "register"]
