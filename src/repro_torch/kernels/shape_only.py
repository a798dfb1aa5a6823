"""The kernels' shape-only path: one registered op per C entry point, for
tensors that hold no data.

A tensor without data (a ``FakeTensor`` on any device, or a ``meta``
tensor) reaches no C entry point: each wrapper allocates what it would
allocate for the card (outputs, ``lse``, the bf16 flash backward's scratch,
decode's partials) and hands them to the op here that stands for its C
entry point. The ops write their outputs in place, as the C entry points
do; under ``FakeTensorMode`` they do nothing (``register_fake``), so a
dry-run (``launch/dryrun.py``) sees every kernel with its shapes, dtypes,
bytes and FLOPs and launches nothing. No launch counter moves.

Each op's FLOPs (``register_flop_formula``, which ``FlopCounterMode`` and
the dry-run's counter read) come from ``kernels/flops.py``, the reference's
counts with causal halved. The formulas it lacks are stated here, each in
its docstring: the backward kernels', and attention that is not causal
self-attention. A count reads the shapes alone: decode counts the whole
cache buffer (``cache_len`` is data).

On real tensors (the tests call them on the CPU) the ops write the plain
versions' values. The wrappers never send a real tensor here: a CUDA tensor
calls its C entry point directly and a CPU tensor takes the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

from . import flops

__all__ = ["data_free", "OPS", "flash_attention_fwd_flops", "flash_attention_bwd_flops",
           "decode_attention_flops", "ssd_scan_flops", "ssd_scan_bwd_flops",
           "rglru_scan_flops", "rglru_scan_bwd_flops"]

Tensor = torch.Tensor


def data_free(t: Tensor) -> bool:
    """Whether ``t`` holds no data: a meta tensor, or a ``FakeTensor`` of
    any device. A plain tensor answers after one type check."""
    if t.is_meta:
        return True
    if type(t) is torch.Tensor:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


# -- FLOP formulas (2 FLOPs a multiply-add, contractions only) -------------------
def flash_attention_fwd_flops(B: int, S: int, T: int, H: int, KV: int, d: int,
                              causal: bool) -> float:
    """``flops.flash_attention_flops`` for causal self-attention (S == T);
    otherwise QK^T and PV over every (query, key) pair, 2·2·B·H·S·T·d,
    halved when causal."""
    if causal and S == T:
        return flops.flash_attention_flops(B, S, H, KV, d)
    return 2.0 * 2.0 * B * H * S * T * d * (0.5 if causal else 1.0)


def flash_attention_bwd_flops(B: int, S: int, H: int, KV: int, d: int) -> float:
    """The backward of causal self-attention: five products of the forward's
    size (QK^T recomputed, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q)
    against the forward's two, so 2.5 × ``flops.flash_attention_flops``."""
    return 2.5 * flops.flash_attention_flops(B, S, H, KV, d)


def decode_attention_flops(B: int, T: int, H: int, d: int) -> float:
    """``flops.decode_attention_flops`` over the whole T-slot buffer (or
    shard): the live length is data."""
    return flops.decode_attention_flops(B, T, H, d)


def ssd_scan_flops(B: int, S: int, H: int, P: int, G: int, N: int) -> float:
    """``flops.ssd_scan_flops``."""
    return flops.ssd_scan_flops(B, S, H, P, G, N)


def ssd_scan_bwd_flops(B: int, S: int, H: int, P: int, G: int, N: int) -> float:
    """The SSD backward: each of the forward count's three (P, N)
    contractions has two adjoint products, so 2 × ``flops.ssd_scan_flops``
    = 12·B·S·H·P·N."""
    return 2.0 * flops.ssd_scan_flops(B, S, H, P, G, N)


def rglru_scan_flops(B: int, S: int, W: int) -> float:
    """``flops.rglru_scan_flops``."""
    return flops.rglru_scan_flops(B, S, W)


def rglru_scan_bwd_flops(B: int, S: int, W: int) -> float:
    """The RG-LRU backward: g_t = dh_t + a_{t+1} g_{t+1} (one multiply-add)
    and da_t = g_t a_t h_{t-1} (one more), 2 × ``flops.rglru_scan_flops``
    = 4·B·S·W."""
    return 2.0 * flops.rglru_scan_flops(B, S, W)


# -- the ops ----------------------------------------------------------------------
def _write(dst: Tensor, value: Tensor) -> None:
    dst.copy_(value.to(dst.dtype))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=("out", "lse"))
def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, causal: bool,
               window: Optional[int], scale: float) -> None:
    """``flash_attention_fwd``'s C entry: out (B,S,H,d), and lse (B,H,S)
    float32 unless it has no elements (the forward without it)."""
    from .flash_attention import flash_attention_lse_ref, flash_attention_ref
    _write(out, flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale))
    if lse.numel():
        _write(lse, flash_attention_lse_ref(q, k, causal=causal, window=window, scale=scale))


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=("scratch", "dq", "dk", "dv"))
def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
               scratch: Tensor, dq: Tensor, dk: Tensor, dv: Tensor, causal: bool,
               window: Optional[int], scale: float) -> None:
    """``flash_attention_bwd``'s C entry: dq, dk, dv, and its f32 scratch."""
    from .flash_attention import flash_attention_bwd_ref
    for dst, val in zip((dq, dk, dv), flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window, scale=scale)):
        _write(dst, val)


@torch.library.custom_op("repro_torch::decode_attention",
                         mutates_args=("part_ml", "part_acc", "out"))
def _decode(q: Tensor, k_cache: Tensor, v_cache: Tensor, cache_len: Tensor, part_ml: Tensor,
            part_acc: Tensor, out: Tensor, window: Optional[int], scale: float) -> None:
    """``decode_attention_fwd``'s C entry: out (B,1,H,d), and the partials."""
    from .decode_attention import decode_attention_ref
    _write(out, decode_attention_ref(q, k_cache, v_cache, cache_len, window=window,
                                     scale=scale))


@torch.library.custom_op("repro_torch::decode_attention_partial",
                         mutates_args=("part_ml", "part_acc", "o", "lse"))
def _decode_partial(q: Tensor, k_shard: Tensor, v_shard: Tensor, cache_len: Tensor,
                    part_ml: Tensor, part_acc: Tensor, o: Tensor, lse: Tensor, kv_offset: int,
                    window: Optional[int], scale: float) -> None:
    """``decode_attention_partial_fwd``'s C entry: o (B,1,H,d) and lse (B,H)
    float32, and the partials."""
    from .decode_attention import decode_attention_partial_ref
    o_ref, lse_ref = decode_attention_partial_ref(q, k_shard, v_shard, cache_len,
                                                  kv_offset=kv_offset, window=window,
                                                  scale=scale)
    _write(o, o_ref)
    _write(lse, lse_ref)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=("y", "state"))
def _ssd(x: Tensor, a_log: Tensor, b: Tensor, c: Tensor, y: Tensor, state: Tensor,
         chunk: int) -> None:
    """``ssd_scan``'s C entry points: y (B,S,H,P) and the final state (B,H,P,N)
    float32."""
    from .ssd_scan import ssd_chunked
    y_ref, state_ref = ssd_chunked(x, a_log, b, c, chunk)
    _write(y, y_ref)
    _write(state, state_ref)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=("dx", "da", "db", "dc"))
def _ssd_bwd(x: Tensor, a_log: Tensor, b: Tensor, c: Tensor, dy: Tensor,
             dstate: Optional[Tensor], dx: Tensor, da: Tensor, db: Tensor, dc: Tensor,
             chunk: int) -> None:
    """``ssd_scan_bwd``'s C entry points: dx, da_log, db, dc."""
    from .ssd_scan import ssd_scan_bwd_ref
    for dst, val in zip((dx, da, db, dc), ssd_scan_bwd_ref(x, a_log, b, c, dy, dstate, chunk)):
        _write(dst, val)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=("h", "h_last"))
def _rglru(a_log: Tensor, b: Tensor, h: Tensor, h_last: Tensor) -> None:
    """``rglru_scan_fwd``'s C entry: h (B,S,W) and h_last (B,W) float32."""
    from .rglru_scan import rglru_scan_ref
    h_ref, last_ref = rglru_scan_ref(a_log, b)
    _write(h, h_ref)
    _write(h_last, last_ref)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=("da", "db"))
def _rglru_bwd(a_log: Tensor, h: Tensor, dh: Optional[Tensor], dh_last: Optional[Tensor],
               da: Tensor, db: Tensor) -> None:
    """``rglru_scan_bwd``'s C entry: da_log and db (B,S,W) float32."""
    from .rglru_scan import rglru_scan_bwd_ref
    for dst, val in zip((da, db), rglru_scan_bwd_ref(a_log, h, dh, dh_last)):
        _write(dst, val)


OPS = {"flash_attention": _flash_fwd, "flash_attention_bwd": _flash_bwd,
       "decode_attention": _decode, "decode_attention_partial": _decode_partial,
       "ssd_scan": _ssd, "ssd_scan_bwd": _ssd_bwd, "rglru_scan": _rglru,
       "rglru_scan_bwd": _rglru_bwd}

for _op in OPS.values():
    _op.register_fake(lambda *args, **kwargs: None)


# -- FLOP formulas on the ops (shapes in, as FlopCounterMode passes them) ----------
def _flops_of(name: str):
    def register(formula):
        packet = getattr(torch.ops.repro_torch, name)
        if packet not in flop_registry:
            register_flop_formula(packet)(formula)
        return formula
    return register


# (counted as ints, as FlopCounterMode's own formulas are: the counts are
# whole numbers, and a float sum over a step would round)
@_flops_of("flash_attention_fwd")
def _flash_fwd_count(q, k, v, o, lse, causal, window, scale, **_) -> int:
    B, S, H, d = q
    return round(flash_attention_fwd_flops(B, S, k[1], H, k[2], d, causal))


@_flops_of("flash_attention_bwd")
def _flash_bwd_count(q, k, *_, **__) -> int:
    B, S, H, d = q
    return round(flash_attention_bwd_flops(B, S, H, k[2], d))


@_flops_of("decode_attention")
def _decode_count(q, k_cache, *_, **__) -> int:
    return round(decode_attention_flops(q[0], k_cache[1], q[2], q[3]))


@_flops_of("decode_attention_partial")
def _decode_partial_count(q, k_shard, *_, **__) -> int:
    return round(decode_attention_flops(q[0], k_shard[1], q[2], q[3]))


@_flops_of("ssd_scan")
def _ssd_count(x, a_log, b, *_, **__) -> int:
    B, S, H, P = x
    return round(ssd_scan_flops(B, S, H, P, b[2], b[3]))


@_flops_of("ssd_scan_bwd")
def _ssd_bwd_count(x, a_log, b, *_, **__) -> int:
    B, S, H, P = x
    return round(ssd_scan_bwd_flops(B, S, H, P, b[2], b[3]))


@_flops_of("rglru_scan")
def _rglru_count(a_log, *_, **__) -> int:
    return round(rglru_scan_flops(*a_log))


@_flops_of("rglru_scan_bwd")
def _rglru_bwd_count(a_log, *_, **__) -> int:
    return round(rglru_scan_bwd_flops(*a_log))
