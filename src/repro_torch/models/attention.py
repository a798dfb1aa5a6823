"""Attention: GQA and DeepSeek's multi-head latent attention (PyTorch
counterpart of ``repro.models.attention``).

Layouts: q (B, S, H, hd); k/v (B, T, KV, hd). GQA groups are computed via
einsum without materialising repeated K/V. The kernel dispatch points are
the JAX package's: flash attention for causal prefill without a prefix,
the decode kernel on every decode step; ``repro_torch.kernels`` then picks
the CUDA kernel or the plain version by the tensors' device. MLA has no
kernel in the JAX package and none here: it runs as einsums, its decode in
the compressed latent space.
"""
from __future__ import annotations

from typing import Optional, Tuple

import functools

import torch

from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.decode_attention import decode_attention_ref
from .common import apply_rope
from .sharding_utils import (BATCH, P, is_dtensor, key_shard, maybe_shard, on_shards, relayout,
                             replicate_like, rows_of, summed, summed_where)

NEG_INF = -2.0e38

__all__ = ["NEG_INF", "gqa_attention", "gqa_attention_chunked", "decode_attention",
           "decode_attention_ref", "mla_prefill", "mla_decode"]


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


# -- MLA (DeepSeek-V2 §2.1) --------------------------------------------------------
def mla_prefill(cq: torch.Tensor, ckv: torch.Tensor, k_rope: torch.Tensor,
                wq_nope: torch.Tensor, wq_rope: torch.Tensor,
                wk_nope: torch.Tensor, wv: torch.Tensor, *,
                rope_theta: float, causal: bool = True,
                q_chunk: Optional[int] = None) -> torch.Tensor:
    """Multi-head latent attention, materialised (prefill/training) path.

    cq:  (B, S, Rq)      — compressed queries (post q_a + norm)
    ckv: (B, T, Rkv)     — compressed KV latent (post kv_a + norm)
    k_rope: (B, T, dr)   — decoupled RoPE key (shared across heads, pre-rope)
    wq_nope: (Rq, H, dn); wq_rope: (Rq, H, dr)
    wk_nope: (Rkv, H, dn); wv: (Rkv, H, dv)
    Returns (B, S, H, dv). ``q_chunk`` bounds score memory for long S: each
    chunk is recomputed in the backward (``torch.utils.checkpoint``), as the
    JAX package wraps it in ``jax.remat``.

    Under a mesh (DTensor arguments) each rank attends its own heads of its
    own batch rows (``on_shards``): the latents whole over "model", the
    weights head-sharded over "model" and gathered over the batch axes, the
    output laid out as the reference's P(batch, None, "model", None)."""
    if is_dtensor(cq):
        fn = functools.partial(mla_prefill, rope_theta=rope_theta, causal=causal,
                               q_chunk=q_chunk)
        from torch.distributed.tensor import Replicate, Shard
        # the batch rows over the batch axes, the heads (dim 1) over "model"
        x_in = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cq.placements)
        w_in = tuple(Shard(1) if p.is_shard(1) else Replicate() for p in wq_nope.placements)
        x_grad = summed_where(x_in, w_in, (1,))
        w_grad = summed_where(w_in, x_in, (0,))
        return on_shards(fn, (cq, ckv, k_rope, wq_nope, wq_rope, wk_nope, wv),
                         ins=(x_in,) * 3 + (w_in,) * 4, grads=(x_grad,) * 3 + (w_grad,) * 4,
                         outs=tuple(Shard(2) if w.is_shard(1) else x
                                    for x, w in zip(x_in, w_in)))
    S = cq.shape[1]
    T = ckv.shape[1]
    k_nope = torch.einsum("btr,rhd->bthd", ckv, wk_nope)
    v = torch.einsum("btr,rhd->bthd", ckv, wv)
    k_pos = torch.arange(T, device=cq.device)[None, :]
    k_rope_r = apply_rope(k_rope[:, :, None, :], k_pos, rope_theta)[:, :, 0]   # (B,T,dr)

    def block(cq_blk: torch.Tensor, offset: int) -> torch.Tensor:
        q_nope = torch.einsum("bsr,rhd->bshd", cq_blk, wq_nope)
        q_rope = torch.einsum("bsr,rhd->bshd", cq_blk, wq_rope)
        q_nope = maybe_shard(q_nope, P(BATCH, None, "model", None))
        q_pos = torch.arange(cq_blk.shape[1], device=cq.device)[None, :] + offset
        q_rope = apply_rope(q_rope, q_pos, rope_theta)
        dn, dr = q_nope.shape[-1], q_rope.shape[-1]
        scale = (dn + dr) ** -0.5
        logits = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope_r)).float() * scale
        logits = maybe_shard(logits, P(BATCH, "model", None, None))
        bias = _mask_bias(cq_blk.shape[1], T, causal=causal, window=None, prefix_len=0,
                          offset=offset, device=cq.device)
        w = torch.softmax(logits + bias, dim=-1).to(cq.dtype)
        out = torch.einsum("bhst,bthd->bshd", w, v)
        return maybe_shard(out, P(BATCH, None, "model", None))

    if not q_chunk or S <= q_chunk or S % q_chunk:
        return block(cq, 0)
    outs = []
    for i in range(0, S, q_chunk):
        blk = cq[:, i:i + q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, blk, i, use_reentrant=False))
        else:
            outs.append(block(blk, i))
    return torch.cat(outs, dim=1)


def mla_decode(cq: torch.Tensor, ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
               cache_len: torch.Tensor, wq_nope: torch.Tensor, wq_rope: torch.Tensor,
               wk_nope: torch.Tensor, wv: torch.Tensor, *,
               rope_theta: float) -> torch.Tensor:
    """Weight-absorbed MLA decode: attention runs in the compressed latent
    space, the cache stays (B, T, Rkv) + (B, T, dr).

    cq: (B, 1, Rq). krope_cache rows are stored *post-rope*. Returns
    (B, 1, H, dv).

    Under a mesh (caches laid out by ``cache_specs``, their slots sharded)
    each rank scores every head's latent query against its own slots, with
    their global positions, and the ranks' partial contexts (in the latent
    space) merge by log-sum-exp (``ops.merge_partials``) before ``wv``."""
    q_nope = torch.einsum("bsr,rhd->bshd", cq, wq_nope)          # (B,1,H,dn)
    q_rope = torch.einsum("bsr,rhd->bshd", cq, wq_rope)
    q_rope = apply_rope(q_rope, cache_len[:, None] - 1, rope_theta)
    # absorb W_uk: q' = q_nope @ wk_nope^T  -> latent-space query
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_nope)      # (B,1,H,Rkv)
    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    scale = (dn + dr) ** -0.5
    if is_dtensor(ckv_cache):
        ctx = _mla_context_on_shards(q_lat, q_rope, ckv_cache, krope_cache, cache_len, scale)
    else:
        ctx = _mla_context(q_lat, q_rope, ckv_cache, krope_cache, cache_len, scale)[0]
    return torch.einsum("bshr,rhd->bshd", ctx, wv)               # (B,1,H,dv)


def _mla_context(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
                 krope: torch.Tensor, cache_len: torch.Tensor, scale: float,
                 kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx (B,1,H,Rkv) in q_lat's type, lse (B,1,H) float32): the latent
    context of slots ``kv_offset`` to ``kv_offset + T`` of the caches, slot
    j live below ``cache_len``, normalised over the live slots, and the log
    of its softmax denominator (NEG_INF, ctx 0, where none is live)."""
    logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, krope)).float() * scale
    T = ckv.shape[1]
    ok = torch.arange(T, device=q_lat.device)[None, :] + kv_offset < cache_len[:, None]
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q_lat.dtype)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv)                 # (B,1,H,Rkv)
    live = ok.any(dim=-1)[:, None, None]
    lse = torch.where(live, torch.logsumexp(logits, dim=-1), NEG_INF).transpose(1, 2)
    return torch.where(live[..., None], ctx, 0.0), lse


def _mla_context_on_shards(q_lat, q_rope, ckv, krope, cache_len, scale: float):
    """``_mla_context`` of DTensors: every head's queries gathered and laid
    out by the caches' batch rows, each rank's partial over its own slots,
    merged across the mesh dims that shard them; the context laid out by
    batch rows."""
    from torch.distributed.tensor import DTensor
    at = key_shard(ckv)
    if at is None or tuple(ckv.placements) != tuple(krope.placements):
        raise ValueError(f"MLA caches laid out as {ckv.placements} / {krope.placements}: "
                         "cache_specs shards only the batch and the sequence, evenly")
    offset, dims = at
    ops.decode_branch["sharded_keys"] += 1
    rows = rows_of(ckv)
    q_l, r_l, len_l = (relayout(summed(replicate_like(t, ckv)), rows).to_local()
                       for t in (q_lat, q_rope, cache_len))
    ctx, lse = _mla_context(q_l, r_l, ckv.to_local(), krope.to_local(), len_l, scale, offset)
    ctx = ops.merge_partials(ctx.float(), lse, ckv.device_mesh, dims).to(q_lat.dtype)
    return DTensor.from_local(ctx, ckv.device_mesh, rows, run_check=False, shape=q_lat.shape,
                              stride=q_lat.stride())
