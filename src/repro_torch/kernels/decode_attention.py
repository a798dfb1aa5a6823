"""Decode attention (one new token against a KV cache): CUDA kernel
wrapper, launch counter and plain PyTorch version.

Replaces the Pallas TPU kernel ``_decode_kernel`` in
``src/repro/kernels/decode_attention.py``; the kernel itself is
``csrc/decode_attention.cu``, whose header says what bounds it on an H100
and what its design does about that.

``decode_attention`` launches the kernel for CUDA tensors (or raises) and
takes ``decode_attention_ref`` for CPU tensors. The kernel is split-KV
flash-decoding: ``split_plan`` cuts the cache into key ranges from the
shapes alone (never from ``cache_len``, which stays on the device), one
CUDA kernel writes each range's partial softmax and a second merges them.
``launches`` counts wrapper calls that launched, one a call however many
CUDA kernels that call runs, and nothing else.
``decode_attention_splits_ref`` is the same split/combine algorithm in
plain PyTorch, for the tests; nothing on the serving path calls it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from ._guard import refuse_dtensor, require_no_grad

NEG_INF = -2.0e38
HEAD_DIMS = (16, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TILE = 32        # keys: a split is a whole number of these
HEADS_PER_BLOCK = 16   # query heads a block of the bf16 kernel scores (its mma rows)
SMS = 132              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4      # split until the grid has up to this many blocks per SM, where T allows

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


def split_plan(T: int, B: int, KV: int, G: int) -> Tuple[int, int]:
    """(split_len, n_splits) for a (B, T, KV, d) cache read by G query heads
    per KV head: up to ``BLOCKS_PER_SM`` blocks per SM (with two warps a
    block, that many keep enough loads in flight to stream the cache, and
    at D <= 128 they are all resident at once, so no second wave trails),
    each split a whole number of ``SPLIT_TILE`` keys and at least one. Split
    ``s`` covers keys [s * split_len, min((s + 1) * split_len, T)), and
    together they cover [0, T) once. Depends on the shapes alone, so it
    never syncs."""
    tiles = max(1, -(-T // SPLIT_TILE))
    blocks = B * KV * -(-G // HEADS_PER_BLOCK)
    want = max(1, BLOCKS_PER_SM * SMS // blocks)
    per = -(-tiles // min(tiles, want))
    return per * SPLIT_TILE, -(-tiles // per)


def decode_attention_splits_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                                window: Optional[int] = None, scale: Optional[float] = None,
                                split_len: int, n_splits: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: a partial (m, l, acc) per
    key range of ``split_len`` (m = NEG_INF, l = 0 where the range holds no
    live key), merged by log-sum-exp with weight 0 for empty ranges.
    Weights are rounded to q's type before P V, as in the kernel."""
    B, _, H, d = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, KV, G, d).float()
    lens = cache_len.to(q.device).long().clamp(max=T)[:, None]
    lo = (lens - window).clamp(min=0) if window is not None else torch.zeros_like(lens)
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        s0, s1 = s * split_len, min((s + 1) * split_len, T)
        kpos = torch.arange(s0, s1, device=q.device)[None, :]
        ok = (kpos < lens) & (kpos >= lo)                                   # (B, n)
        k, v = k_cache[:, s0:s1].float(), v_cache[:, s0:s1].float()
        logits = torch.einsum("bkgh,btkh->bkgt", qg, k) * scale
        logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
        m = logits.amax(dim=-1)                                             # (B, KV, G)
        p = torch.where(ok[:, None, None, :], torch.exp(logits - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgt,btkh->bkgh", p.to(q.dtype).float(), v))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)         # split first
    live = l > 0
    m_all = torch.where(live, m, NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(m - m_all), 0.0)
    l_all = (w * l).sum(dim=0)
    out = (w[..., None] * torch.where(live[..., None], acc, 0.0)).sum(dim=0)
    out = torch.where(l_all[..., None] > 0, out / l_all.clamp(min=1e-30)[..., None], 0.0)
    return out.to(q.dtype).reshape(B, 1, H, d)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
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
    refuse_dtensor("decode_attention", q, k_cache, v_cache, cache_len)
    require_no_grad("decode_attention", "'Backward kernels'", q, k_cache, v_cache)
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
    split_len, n_splits = split_plan(T, B, KV, H // KV)
    part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, n_splits, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _lib()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, T, H, KV, d,
        _DTYPES[q.dtype], -1 if window is None else int(window), split_len, n_splits, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("decode_attention kernel: "
                           + lib.decode_attention_error_string(err).decode())
    global launches
    launches += 1
    return out
