"""Decode attention (one new token against a KV cache): CUDA kernel
wrapper, launch counter and plain PyTorch version.

Replaces the Pallas TPU kernel ``_decode_kernel`` in
``src/repro/kernels/decode_attention.py``; the kernel itself is
``csrc/decode_attention.cu``, whose header says what bounds it on an H100
and what its design does about that.

``decode_attention`` launches the kernel for CUDA tensors (or raises) and
takes ``decode_attention_ref`` for CPU tensors. ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cache_len: torch.Tensor, *, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B,1,H,d) against a (B,T,KV,d) cache whose first
    ``cache_len[b]`` rows are valid -> (B,1,H,d). Never dispatches."""
    B, _, H, d = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, KV, G, d)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k_cache).float() * scale
    kpos = torch.arange(T, device=q.device)[None, :]
    lens = cache_len.to(q.device)[:, None]
    ok = kpos < lens
    if window is not None:
        ok = ok & (kpos > lens - 1 - window)
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkh->bkgh", w, v_cache).reshape(B, 1, H, d)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,d); k/v cache (B,T,KV,d); cache_len (B,) -> (B,1,H,d) in q's type."""
    if not q.is_cuda:
        return decode_attention_ref(q, k_cache, v_cache, cache_len, window=window,
                                    scale=scale)
    B, one, H, d = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    tensors = (k_cache, v_cache, cache_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention: q, caches and cache_len must lie on one CUDA device")
    if q.dtype not in _DTYPES or not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"decode_attention: dtype {q.dtype}/{k_cache.dtype}/{v_cache.dtype} "
                         "not supported (float32 or bfloat16, all alike)")
    if (one != 1 or d not in HEAD_DIMS or k_cache.shape != (B, T, KV, d)
            or v_cache.shape != k_cache.shape or tuple(cache_len.shape) != (B,)):
        raise ValueError(f"decode_attention: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                         f"v{tuple(v_cache.shape)} cache_len{tuple(cache_len.shape)} not "
                         f"supported (head_dim in {HEAD_DIMS})")
    if KV == 0 or H % KV:
        raise ValueError(f"decode_attention: {H} heads not a multiple of {KV} KV heads")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: tensors must be 16-byte aligned")
    lens = cache_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _lib()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, T, H, KV, d, _DTYPES[q.dtype],
        -1 if window is None else int(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("decode_attention kernel: "
                           + lib.decode_attention_error_string(err).decode())
    global launches
    launches += 1
    return out
