"""Flash attention (causal / sliding-window / GQA): CUDA kernel wrapper,
launch counter and plain PyTorch version.

Replaces the Pallas TPU kernel ``_flash_kernel`` in
``src/repro/kernels/flash_attention.py``; the kernel itself is
``csrc/flash_attention.cu``, whose header says what bounds it on an H100
and what its design does about that.

``flash_attention`` launches the kernel for CUDA tensors (or raises) and
takes ``flash_attention_ref`` for CPU tensors. ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

NEG_INF = -2.0e38
HEAD_DIMS = {torch.bfloat16: (64, 128, 256), torch.float32: (64, 128)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B,S,H,d), k/v (B,T,KV,d) -> (B,S,H,d). Materialises
    the (S, T) scores; the weights are cast to q's type before the PV product,
    as the JAX reference does."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, S, KV, G, d)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = kpos <= qpos
    if window is not None:
        ok = ok & (kpos > qpos - window)
    logits = logits + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, d)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,d), k/v (B,T,KV,d) with H % KV == 0 -> (B,S,H,d) in q's type."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/{v.dtype} "
                         "not supported (float32 or bfloat16, all alike)")
    if d not in HEAD_DIMS[q.dtype] or k.shape != (B, T, KV, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} not supported (head_dim in "
                         f"{HEAD_DIMS[q.dtype]} for {q.dtype})")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KV} KV heads")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, KV, d,
        _DTYPES[q.dtype], int(causal), -1 if window is None else int(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel: "
                           + lib.flash_attention_error_string(err).decode())
    global launches
    launches += 1
    return out
