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

``decode_attention_partial`` is the sharded-keys mode: the same two kernels
on a rank's shard of a cache sharded over its sequence (keys ``kv_offset``
to ``kv_offset + Tk``, with ``cache_len`` and the window in global
positions), returning the output in float32 normalised over the shard and
the log-sum-exp of its scores, which ``ops`` merges across the ranks. It
counts in ``launches`` too. Its plain version is
``decode_attention_partial_ref``.

A tensor without data (fake or meta) takes the shape-only path
(``kernels/shape_only.py``): the same allocations as the card's call (the
output, ``split_plan``'s partials) handed to the registered op that stands
for the C entry point. It launches nothing and counts nothing. Data-free
tensors on the card's device type get the card's checks; on any other
only the DTensor and no-grad guards apply. A real CUDA tensor calls the C
entry point directly, past one more test (``shape_only.data_free``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from . import shape_only as _shape
from ._guard import refuse_dtensor, require_no_grad

NEG_INF = -2.0e38
HEAD_DIMS = (16, 24, 32, 64, 80, 128, 256)   # either type, both modes
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


def decode_attention_partial_ref(q: torch.Tensor, k_shard: torch.Tensor,
                                 v_shard: torch.Tensor, cache_len: torch.Tensor, *,
                                 kv_offset: int, window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the sharded-keys mode: q (B,1,H,d) against keys
    ``kv_offset`` to ``kv_offset + Tk`` of a cache, (B,Tk,KV,d), key j live
    when its global position ``kv_offset + j`` is below ``cache_len[b]``
    (and, with a window, at or above ``cache_len[b] - window``) -> (o
    (B,1,H,d) float32, the softmax over the shard's live keys applied to V;
    lse (B,H) float32, the natural log of the softmax denominator), o = 0
    and lse = NEG_INF where the shard holds no live key. The weights are
    ``decode_attention_ref``'s (rounded to q's type before P V), so on one
    shard holding the whole cache o is its output. Never dispatches."""
    B, _, H, d = q.shape
    T, KV = k_shard.shape[1], k_shard.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, KV, G, d)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k_shard).float() * scale
    kpos = torch.arange(T, device=q.device)[None, :] + kv_offset
    lens = cache_len.to(q.device)[:, None]
    ok = kpos < lens
    if window is not None:
        ok = ok & (kpos > lens - 1 - window)
    live = ok.any(dim=-1)[:, None, None]                                    # (B, 1, 1)
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkh->bkgh", w, v_shard).float()
    o = torch.where(live[..., None], o, 0.0).reshape(B, 1, H, d)
    lse = torch.where(live, torch.logsumexp(logits, dim=-1), NEG_INF).reshape(B, H)
    return o, lse


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_partial_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention_partial_fwd.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(what: str, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cache_len: torch.Tensor, window: Optional[int], scale: Optional[float],
            kv_offset: Optional[int]):
    """Check the CUDA inputs, launch the partial and combine kernels and count
    the launch: the output in q's type (``kv_offset`` None), or in the
    sharded-keys mode (o float32, lse)."""
    refuse_dtensor(what, q, k_cache, v_cache, cache_len)
    require_no_grad(what, "'Backward kernels'", q, k_cache, v_cache)
    B, one, H, d = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if not q.is_cuda:           # a data-free tensor of another device type
        return _shape_only(what, q, k_cache, v_cache, cache_len, window, scale, kv_offset)
    tensors = (k_cache, v_cache, cache_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{what}: q, caches and cache_len must lie on one CUDA device")
    if q.dtype not in _DTYPES or not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"{what}: dtype {q.dtype}/{k_cache.dtype}/{v_cache.dtype} "
                         "not supported (float32 or bfloat16, all alike)")
    if (one != 1 or d not in HEAD_DIMS or k_cache.shape != (B, T, KV, d)
            or v_cache.shape != k_cache.shape or tuple(cache_len.shape) != (B,)):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                         f"v{tuple(v_cache.shape)} cache_len{tuple(cache_len.shape)} not "
                         f"supported (head_dim in {HEAD_DIMS})")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} heads not a multiple of {KV} KV heads")
    if _shape.data_free(q):
        return _shape_only(what, q, k_cache, v_cache, cache_len, window, scale, kv_offset)
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")
    lens = cache_len.to(torch.int32).contiguous()
    split_len, n_splits = split_plan(T, B, KV, H // KV)
    part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, n_splits, d), dtype=torch.float32, device=q.device)
    scale = float(scale) if scale is not None else d ** -0.5
    window = -1 if window is None else int(window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _lib()
    if kv_offset is None:
        out = torch.empty_like(q)
        err = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, T, H, KV, d,
            _DTYPES[q.dtype], window, split_len, n_splits, scale, stream)
    else:
        out = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
               torch.empty((B, H), dtype=torch.float32, device=q.device))
        err = lib.decode_attention_partial_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), B,
            T, H, KV, d, _DTYPES[q.dtype], window, int(kv_offset), split_len, n_splits, scale,
            stream)
    if err:
        raise RuntimeError(f"{what} kernel: " + lib.decode_attention_error_string(err).decode())
    global launches
    launches += 1
    return out


def _shape_only(what: str, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                cache_len: torch.Tensor, window: Optional[int], scale: Optional[float],
                kv_offset: Optional[int]):
    """``_launch``'s allocations on data-free tensors, handed to the
    registered op of the C entry point (``kernels/shape_only.py``)."""
    B, _, H, d = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    n_splits = split_plan(T, B, KV, H // KV)[1]
    part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, n_splits, d), dtype=torch.float32, device=q.device)
    scale = float(scale) if scale is not None else d ** -0.5
    if kv_offset is None:
        out = torch.empty_like(q)
        _shape.OPS[what](q, k_cache, v_cache, lens, part_ml, part_acc, out, window, scale)
        return out
    out = (torch.empty(q.shape, dtype=torch.float32, device=q.device),
           torch.empty((B, H), dtype=torch.float32, device=q.device))
    _shape.OPS[what](q, k_cache, v_cache, lens, part_ml, part_acc, *out, int(kv_offset), window,
                     scale)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,d); k/v cache (B,T,KV,d); cache_len (B,) -> (B,1,H,d) in q's type."""
    if not q.is_cuda and not _shape.data_free(q):
        return decode_attention_ref(q, k_cache, v_cache, cache_len, window=window,
                                    scale=scale)
    return _launch("decode_attention", q, k_cache, v_cache, cache_len, window, scale, None)


def decode_attention_partial(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                             cache_len: torch.Tensor, *, kv_offset: int,
                             window: Optional[int] = None, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded-keys mode: q (B,1,H,d) against keys ``kv_offset`` to
    ``kv_offset + Tk`` of a cache, k/v (B,Tk,KV,d); ``cache_len`` (B,) and
    ``window`` in global positions -> (o (B,1,H,d) float32, lse (B,H)
    float32); see ``decode_attention_partial_ref``."""
    if not q.is_cuda and not _shape.data_free(q):
        return decode_attention_partial_ref(q, k_shard, v_shard, cache_len,
                                            kv_offset=kv_offset, window=window, scale=scale)
    return _launch("decode_attention_partial", q, k_shard, v_shard, cache_len, window, scale,
                   kv_offset)
