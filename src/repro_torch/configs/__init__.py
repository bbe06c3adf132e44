from .base import ArchConfig
from .registry import ARCHS, get_config, smoke_config

__all__ = ["ArchConfig", "ARCHS", "get_config", "smoke_config"]
