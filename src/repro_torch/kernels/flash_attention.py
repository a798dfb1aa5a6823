"""Flash attention (causal / sliding-window / GQA): CUDA kernel wrappers,
launch counters, plain PyTorch versions and the gradient.

Replaces the Pallas TPU kernel ``_flash_kernel`` in
``src/repro/kernels/flash_attention.py``; the forward is
``csrc/flash_attention.cu``, the backward ``csrc/flash_attention_bwd.cu``
(the JAX package differentiates its query-chunked attention instead; it has
no Pallas backward). Each source's header says what bounds it on an H100
and what its design does about that.

``flash_attention`` launches the forward for CUDA tensors (or raises) and
takes ``flash_attention_ref`` for CPU tensors, through which autograd then
differentiates. On the card, when grad is needed, it goes through
``FlashAttentionFn``: the forward also writes each row's log-sum-exp, and
the backward is ``flash_attention_bwd`` (three kernels a call: dsum, the
main kernel, and a convert of its f32 accumulators; ``bwd_split_plan``
splits a KV head's query group across blocks where the key tiles alone
do not fill the card). Forward and backward take head_dim 16, 24, 32, 64,
80, 128 and 256 in both types (``HEAD_DIMS``, ``BWD_HEAD_DIMS``): every
head_dim of every registered config, full or reduced.
``flash_attention_fwd`` returns the forward's two outputs (out, lse), which
the backward reads; the plain versions are ``flash_attention_ref``,
``flash_attention_lse_ref`` and ``flash_attention_bwd_ref`` (the
FlashAttention-2 formulas written out). ``launches`` counts forward
launches, ``bwd_launches`` backward calls, and nothing else.

A tensor without data (fake or meta) takes the shape-only path
(``kernels/shape_only.py``): the wrapper allocates what the card's call
would (out, lse; the backward's dq, dk, dv and f32 scratch) and calls the
registered op that stands for the C entry point, through
``FlashAttentionFn`` when grad is needed, so a dry-run's backward takes it
too. It launches nothing and counts nothing. Data-free tensors on the
card's device type get the card's checks; on any other they stand for the
plain version's shapes, and the card's head-dim and backward limits are
not applied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from . import shape_only as _shape
from ._guard import refuse_dtensor
from .decode_attention import SMS

NEG_INF = -2.0e38
HEAD_DIMS = {dt: (16, 24, 32, 64, 80, 128, 256) for dt in (torch.bfloat16, torch.float32)}
BWD_HEAD_DIMS = {dt: (16, 24, 32, 64, 80, 128, 256) for dt in (torch.bfloat16, torch.float32)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_KEY_TILE = 128     # keys per block of the bf16 backward kernel up to head_dim 128
BWD_KEY_TILE_256 = 64  # and at head_dim 256 (csrc/flash_attention_bwd.cu's header)

launches = 0
bwd_launches = 0


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled f32 scores (B,KV,G,S,T) and the live mask (S,T)."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, d)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = kpos <= qpos
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return logits, ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: q (B,S,H,d), k/v (B,T,KV,d) -> (B,S,H,d). Materialises
    the (S, T) scores; the weights are cast to q's type before the PV product,
    as the JAX reference does."""
    B, S, H, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    logits, ok = _logits(q, k, causal, window, scale)
    logits = logits + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, d)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the forward's second output: each row's natural-log
    log-sum-exp of its live scaled scores, (B,H,S) float32; +inf for a row
    with no live key."""
    B, S, H, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    logits, ok = _logits(q, k, causal, window, scale)
    lse = torch.logsumexp(logits.masked_fill(~ok, float("-inf")), dim=-1)
    return lse.masked_fill(lse == float("-inf"), float("inf")).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, FlashAttention-2's formulas in float32
    without autograd: P = exp(S scale - lse) on live pairs (0 elsewhere),
    D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K scale,
    dK = dS^T Q scale (summed over each KV head's query group). Returns
    (dq, dk, dv) in the types of q, k, v."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    logits, ok = _logits(qf, kf, causal, window, scale)
    lse_g = lse.float().reshape(B, KV, G, S, 1)
    p = torch.where(ok, torch.exp(logits - lse_g), 0.0)
    dog = dout.float().reshape(B, S, KV, G, d)
    dsum = (dout.float() * out.float()).sum(-1)                       # (B,S,H)
    dsum = dsum.reshape(B, S, KV, G).permute(0, 2, 3, 1)[..., None]   # (B,KV,G,S,1)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    ds = p * (dp - dsum)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf).reshape(B, S, H, d) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf.reshape(B, S, KV, G, d)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_key_tile(head_dim: int) -> int:
    """Keys per block of the bf16 backward kernel at this head_dim."""
    return BWD_KEY_TILE_256 if head_dim == 256 else BWD_KEY_TILE


def bwd_split_plan(B: int, S: int, KV: int, G: int, head_dim: int = 128) -> int:
    """How many blocks share one (key tile, KV head, b) of the bf16
    backward, each taking a contiguous share of the G query heads: 1 where
    the key tiles (``bwd_key_tile(head_dim)`` keys each) x KV x B blocks
    already fill the H100's ``SMS`` SMs, else the smallest divisor of G
    that does (G itself if none does). Split ``sp`` of ``n`` takes query
    heads [sp G // n, (sp + 1) G // n) of the group. Depends on the shapes
    alone."""
    blocks = -(-S // bwd_key_tile(head_dim)) * KV * B
    if blocks >= SMS:
        return 1
    want = -(-SMS // blocks)
    return next((n for n in range(want, G + 1) if G % n == 0), G)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_scratch_floats(B: int, S: int, H: int, KV: int, d: int, dtype: torch.dtype,
                       n_split: int) -> int:
    """The backward's f32 scratch in floats, the C entry
    ``flash_attention_bwd_scratch_floats`` in Python (for the shape-only
    path, which loads no library): float32 the row sums D, (B,H,S); bfloat16
    lse in log2 units and D, (B,H,S_pad) each, the dQ accumulator (B,H,S_pad,
    d + 8), and with a split group the dK and dV accumulators, S_pad = S
    rounded up to 64."""
    if dtype == torch.float32:
        return B * H * S
    rows = B * H * (-(-S // 64) * 64)
    return rows * (2 + d + 8) + (2 * B * S * KV * d if n_split > 1 else 0)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dims) -> None:
    """The card's checks; a data-free tensor of another device type than
    the card's gets only the DTensor refusal."""
    refuse_dtensor("flash_attention", q, k, v)
    if not q.is_cuda and _shape.data_free(q):
        return
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/{v.dtype} "
                         "not supported (float32 or bfloat16, all alike)")
    if d not in head_dims or k.shape != (B, T, KV, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} not supported (head_dim in {head_dims} for "
                         f"{q.dtype})")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads not a multiple of {KV} KV heads")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int], scale: float, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel (inputs checked and contiguous)."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    if _shape.data_free(q):
        _shape.OPS["flash_attention"](q, k, v, out, lse if with_lse else q.new_empty(
            0, dtype=torch.float32), causal, window, scale)
        return out, lse
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be 16-byte aligned")
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, T, H, KV, d, _DTYPES[q.dtype],
        int(causal), -1 if window is None else int(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel: "
                           + lib.flash_attention_error_string(err).decode())
    global launches
    launches += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The card's flash attention with its gradient: the forward kernel with
    the log-sum-exp saved, the backward kernel for dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        out, lse = _forward(q, k, v, True, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,d), k/v (B,T,KV,d) with H % KV == 0 -> (B,S,H,d) in q's type.
    On the card the forward takes head_dim 16, 24, 32, 64, 80, 128 or 256
    in either type (``HEAD_DIMS``). Differentiable: on the card, when grad
    is needed, only causal self-attention (S == T) has a backward, at the
    same head dims (``BWD_HEAD_DIMS``); anything else raises before the
    forward runs."""
    if not q.is_cuda and not _shape.data_free(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check_inputs(q, k, v, HEAD_DIMS.get(q.dtype, ()))
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        bwd_dims = BWD_HEAD_DIMS.get(q.dtype, ())
        if q.is_cuda and (not causal or q.shape[1] != k.shape[1]
                          or q.shape[-1] not in bwd_dims):
            raise NotImplementedError(
                f"flash_attention: no backward on the card for causal={causal}, S="
                f"{q.shape[1]}, T={k.shape[1]}, head_dim {q.shape[-1]} {q.dtype} (causal "
                f"self-attention at head_dim {bwd_dims} only; ROADMAP: 'Backward kernels')")
        return FlashAttentionFn.apply(q, k, v, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its second output: (out (B,S,H,d), lse (B,H,S)
    float32), the log-sum-exp that ``flash_attention_bwd`` reads. Not
    differentiable; CPU tensors take the plain versions."""
    if not q.is_cuda and not _shape.data_free(q):
        return (flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale),
                flash_attention_lse_ref(q, k, causal=causal, window=window, scale=scale))
    _check_inputs(q, k, v, HEAD_DIMS.get(q.dtype, ()))
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    q, k, v = (t.detach().contiguous() for t in (q, k, v))
    return _forward(q, k, v, causal, window, scale, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal self-attention from the forward's inputs, its
    output ``out`` and log-sum-exp ``lse`` (B,H,S) float32, and the output's
    gradient ``dout``; in the types of q, k, v. CUDA tensors launch the
    backward kernels (one count a call), CPU tensors take the plain version.
    In bfloat16 dq (and, with a split group, dk and dv) is summed in f32 in
    an order that changes from run to run: not bit-reproducible."""
    free = _shape.data_free(q)
    if not q.is_cuda and not free:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                       scale=scale)
    _check_inputs(q, k, v, BWD_HEAD_DIMS.get(q.dtype, ()))
    B, S, H, d = q.shape
    KV = k.shape[2]
    if not causal or k.shape[1] != S:
        raise ValueError(f"flash_attention_bwd: causal self-attention only (causal={causal}, "
                         f"S={S}, T={k.shape[1]})")
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or not all(t.device == q.device for t in (out, lse, dout))):
        raise ValueError(f"flash_attention_bwd: out{tuple(out.shape)} {out.dtype}, "
                         f"lse{tuple(lse.shape)} {lse.dtype}, dout{tuple(dout.shape)} do not "
                         f"match q{tuple(q.shape)} {q.dtype}")
    q, k, v, out, lse = (t.contiguous() for t in (q, k, v, out, lse))
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_split = bwd_split_plan(B, S, KV, H // KV, d) if q.dtype == torch.bfloat16 else 1
    scale = float(scale) if scale is not None else d ** -0.5
    if free:
        scratch = torch.empty(bwd_scratch_floats(B, S, H, KV, d, q.dtype, n_split),
                              dtype=torch.float32, device=q.device)
        _shape.OPS["flash_attention_bwd"](q, k, v, out, lse, dout, scratch, dq, dk, dv, causal,
                                          window, scale)
        return dq, dk, dv
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: tensors must be 16-byte aligned")
    dtype = _DTYPES[q.dtype]
    lib = _bwd_lib()
    # f32 scratch: the row sums D, and in bf16 also lse in log2 units and the
    # f32 accumulators (zeroed by the first kernel)
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(B, S, H, KV, d, dtype, n_split),
                          dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, KV, d, dtype, -1 if window is None else int(window), n_split, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention_bwd kernels: "
                           + lib.flash_attention_bwd_error_string(err).decode())
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv
