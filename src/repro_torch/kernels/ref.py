"""Plain PyTorch versions of every ported kernel (the allclose ground
truth on the card, and what CPU tensors run)."""
from __future__ import annotations

from .decode_attention import decode_attention_ref
from .flash_attention import flash_attention_ref

__all__ = ["flash_attention_ref", "decode_attention_ref"]
