from .config import ArchConfig
from .registry import Model, build_model
from .transformer import LM

__all__ = ["ArchConfig", "Model", "build_model", "LM"]
