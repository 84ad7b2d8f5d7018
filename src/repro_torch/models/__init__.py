"""LM substrate of the port: configs, layers, models."""
from .config import ArchConfig, Block
from . import layers, model

__all__ = ["ArchConfig", "Block", "layers", "model"]
