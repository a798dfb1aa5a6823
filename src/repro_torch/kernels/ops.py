"""Public kernel entry points.

Dispatch goes by the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, a CPU tensor takes the plain
PyTorch version (``ref.py``). There is no switch that sends a CUDA tensor
down the plain path.
"""
from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention

__all__ = ["flash_attention", "decode_attention"]
