"""Public kernel entry points.

Dispatch goes by the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, a CPU tensor takes the plain
PyTorch version (``ref.py``). There is no switch that sends a CUDA tensor
down the plain path, and no shape condition: the JAX package's tile
conditions (``src/repro/kernels/ops.py``) come from its Pallas tiling,
which the CUDA kernels do not share.
"""
from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention, flash_attention_bwd, flash_attention_fwd
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "ssd_scan_bwd", "rglru_scan"]
