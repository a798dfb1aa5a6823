"""Attention for the dense GQA path (PyTorch counterpart of
``repro.models.attention``).

Layouts: q (B, S, H, hd); k/v (B, T, KV, hd). GQA groups are computed via
einsum without materialising repeated K/V. The kernel dispatch points are
the JAX package's: flash attention for causal prefill without a prefix,
the decode kernel on every decode step; ``repro_torch.kernels`` then picks
the CUDA kernel or the plain version by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import functools

import torch

from ..kernels import ops
from ..kernels.decode_attention import decode_attention_ref
from .sharding_utils import is_dtensor

NEG_INF = -2.0e38

__all__ = ["NEG_INF", "gqa_attention", "gqa_attention_chunked", "decode_attention",
           "decode_attention_ref"]


def _mask_bias(s_len: int, t_len: int, *, causal: bool, window: Optional[int],
               prefix_len: int, offset: int, device=None) -> torch.Tensor:
    """(s_len, t_len) additive f32 bias. ``offset`` = absolute position of
    the first query row (for chunked prefill / decode)."""
    qpos = torch.arange(s_len, device=device)[:, None] + offset
    kpos = torch.arange(t_len, device=device)[None, :]
    ok = torch.ones((s_len, t_len), dtype=torch.bool, device=device)
    if causal:
        ok = kpos <= qpos
        if prefix_len > 0:
            ok = ok | (kpos < prefix_len)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, 0.0, NEG_INF)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention. Returns (B, S, H, hd). DTensors go through
    the kernels' DTensor entry (``ops.attend_on_shards``)."""
    if is_dtensor(q, k, v):
        return ops.attend_on_shards(functools.partial(
            gqa_attention, causal=causal, window=window, prefix_len=prefix_len, offset=offset,
            scale=scale), q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    bias = _mask_bias(S, k.shape[1], causal=causal, window=window,
                      prefix_len=prefix_len, offset=offset, device=q.device)
    w = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def gqa_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          prefix_len: int = 0, q_chunk: int = 1024,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Query-chunked attention: bounds live score memory at (B, H, q_chunk, T).
    Causal attention without a prefix goes to the flash kernel."""
    if causal and prefix_len == 0:
        return ops.flash_attention(q, k, v, causal=True, window=window, scale=scale)
    S = q.shape[1]
    if S % q_chunk:
        return gqa_attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len, scale=scale)
    outs = [gqa_attention(q[:, i:i + q_chunk], k, v, causal=causal, window=window,
                          prefix_len=prefix_len, offset=i, scale=scale)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position decode vs a (B, T, KV, hd) cache.

    q: (B, 1, H, hd); ``cache_len``: (B,) int32 — number of valid cache
    entries (the new token's k/v must already be written at
    ``cache_len - 1``)."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len, window=window, scale=scale)
