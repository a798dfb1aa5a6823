"""Plain PyTorch versions of every ported kernel (the allclose ground
truth on the card, and what CPU tensors run)."""
from __future__ import annotations

from .decode_attention import decode_attention_ref
from .flash_attention import (flash_attention_bwd_ref, flash_attention_lse_ref,
                              flash_attention_ref)
from .rglru_scan import rglru_scan_ref
from .ssd_scan import ssd_chunked as ssd_scan_ref
from .ssd_scan import ssd_scan_bwd_ref

__all__ = ["flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "decode_attention_ref", "ssd_scan_ref", "ssd_scan_bwd_ref", "rglru_scan_ref"]
