"""RG-LRU linear recurrence h_t = exp(a_log_t) h_{t-1} + b_t: CUDA kernel
wrapper, launch counter and plain PyTorch version.

Replaces the Pallas TPU kernel ``_rglru_kernel`` in
``src/repro/kernels/rglru_scan.py``; the kernel itself is
``csrc/rglru_scan.cu``, whose header says what bounds it on an H100 and
what its design does about that.

``rglru_scan`` launches the kernel for CUDA tensors (or raises) and takes
``rglru_scan_ref`` for CPU tensors. ``launches`` counts kernel launches
and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from ._guard import require_no_grad

launches = 0


def rglru_scan_ref(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a_log, b (B,S,W) -> (h (B,S,W) f32, h_last (B,W) f32),
    from a zero state, as a Hillis–Steele doubling scan over the sequence
    axis (⌈log2 S⌉ rounds of whole-tensor products, the TPU kernel's
    algorithm; PyTorch has no public associative scan)."""
    a = torch.exp(a_log.float())
    h = b.float()
    k, S = 1, h.shape[1]
    while k < S:
        h = torch.cat([h[:, :k], h[:, k:] + a[:, k:] * h[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return h, h[:, -1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.rglru_scan_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_log, b (B,S,W) float32 -> (h (B,S,W) float32, h_last (B,W) float32)."""
    if not a_log.is_cuda:
        return rglru_scan_ref(a_log, b)
    require_no_grad("rglru_scan", "'Backward kernels'", a_log, b)
    if not (b.is_cuda and b.device == a_log.device):
        raise ValueError("rglru_scan: a_log and b must lie on one CUDA device")
    if a_log.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rglru_scan: dtype a_log {a_log.dtype}, b {b.dtype} not supported "
                         "(float32)")
    if a_log.ndim != 3 or a_log.shape != b.shape or a_log.shape[1] == 0:
        raise ValueError(f"rglru_scan: shapes a_log{tuple(a_log.shape)} b{tuple(b.shape)} "
                         "not supported (equal, (B,S,W), S > 0)")
    B, S, W = a_log.shape
    a_log, b = a_log.contiguous(), b.contiguous()
    h = torch.empty_like(b)
    h_last = torch.empty((B, W), dtype=torch.float32, device=b.device)
    lib = _lib()
    err = lib.rglru_scan_fwd(a_log.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(),
                             B, S, W, torch.cuda.current_stream(b.device).cuda_stream)
    if err:
        raise RuntimeError("rglru_scan kernel: " + lib.rglru_scan_error_string(err).decode())
    global launches
    launches += 1
    return h, h_last
