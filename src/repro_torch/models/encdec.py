"""Encoder-decoder transformer, Whisper's backbone (PyTorch counterpart of
``repro.models.encdec``).

The conv audio frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, enc_seq, D) in the model's dtype. Norms
are RMSNorm, as the reference's. ``EncDecLM`` exposes the ``LM`` interface:

    init(gen)                                          → params
    encode(params, frames, remat=)                     → (B, T, D)
    apply(params, tokens, encoder_frames=, remat=)     → (logits, aux)
    loss(params, batch, remat=)                        → (nll, {"nll", "aux"})
    init_cache(batch, max_len)                         → {"self", "cross"}
    prefill(params, tokens, cache, encoder_frames=)    → (logits, cache)
    decode(params, token, cache, pos)                  → (logits, cache)

Parameters keep the JAX package's tree: ``enc`` and ``dec`` hold each
layer's leaves stacked on a leading (n_layers, ...) axis, beside
``embed`` (tied with the head), ``enc_pos``, ``ln_enc`` and ``ln_f``. The
encoder's self-attention and every cross-attention are non-causal plain
GQA, as the reference computes them; the decoder's self-attention takes
the flash kernel above ``attn_chunk`` and the decode kernel on every decode
step. As ``LM`` does, prefill and decode write the caches in place (the
cross cache once, at prefill) and return the same cache object.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention as attn_lib
from .common import apply_rope, dtype_of, embed_init, resolve_device, rms_norm, zeros
from .config import ArchConfig
from .mlp import apply_mlp, init_mlp
from .sharding_utils import BATCH, P, is_dtensor, maybe_shard, replicate_like
from .transformer import (GATHERED, RESIDUAL, Params, _fit_cache, _heads_in, _heads_out,
                          _layer, _unbind, _write_cache, gathered_table, head, init_attn,
                          token_nll)


def _normed(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The RMS-normed residual stream as the projections take it: under a
    mesh its sequence gathered (the residual stream is sequence-sharded over
    "model"), as ``LM``'s blocks take it."""
    return maybe_shard(rms_norm(x, scale, eps), GATHERED)


def _add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual add, the branch ``y`` laid out as the residual stream
    first (a reduce-scatter of the row-parallel product under a mesh)."""
    return maybe_shard(x + maybe_shard(y, RESIDUAL), RESIDUAL)


def _init_enc_layers(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> Params:
    d = cfg.d_model
    return {"ln1": zeros((n, d), gen.device),
            "attn": init_attn(gen, cfg, dtype, lead=(n,)),
            "ln2": zeros((n, d), gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype, lead=(n,))}


def _init_dec_layers(gen: torch.Generator, cfg: ArchConfig, dtype, n: int) -> Params:
    d = cfg.d_model
    return {"ln1": zeros((n, d), gen.device),
            "self_attn": init_attn(gen, cfg, dtype, lead=(n,)),
            "ln_x": zeros((n, d), gen.device),
            "cross_attn": init_attn(gen, cfg, dtype, lead=(n,)),
            "ln2": zeros((n, d), gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype, lead=(n,))}


def _attn_noncausal(p: Params, x: torch.Tensor) -> torch.Tensor:
    q, k, v = (_heads_in(x, p[w]) for w in ("wq", "wk", "wv"))
    return _heads_out(attn_lib.gqa_attention(q, k, v, causal=False), p["wo"])


def _cross_kv(p: Params, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _heads_in(enc_out, p["wk"]), _heads_in(enc_out, p["wv"])


def _cross_attn(p: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    q = _heads_in(x, p["wq"])
    return _heads_out(attn_lib.gqa_attention(q, k, v, causal=False), p["wo"])


def _cross_attn_decode(p: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """Cross-attention of one decode step against the cross cache. Under a
    mesh (the cache's frames sharded by ``cache_specs``) the decode kernel's
    sharded-keys mode reads each rank's frames, every one of them live, and
    the ranks merge (``ops.decode_attention``), so the cache is never
    gathered; on one device the plain non-causal attention, as the JAX
    package computes it."""
    if not is_dtensor(k):
        return _cross_attn(p, x, k, v)
    q = _heads_in(x, p["wq"])
    n = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=k.device)
    return _heads_out(attn_lib.decode_attention(q, k, v, n), p["wo"])


def _self_attn(p: Params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[Params], pos: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder's causal self-attention (rope, no qk-norm, no window);
    prefill and decode write ``cache`` in place."""
    S = x.shape[1]
    positions = pos[:, None] if mode == "decode" else torch.arange(S, device=x.device)[None, :]
    q, k, v = (_heads_in(x, p[w]) for w in ("wq", "wk", "wv"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        _write_cache(cache["k"], k, pos)
        _write_cache(cache["v"], v, pos)
        o = attn_lib.decode_attention(q, cache["k"], cache["v"], pos + 1)
        return _heads_out(o, p["wo"])
    if S > cfg.attn_chunk:
        # long prefill: never materialize the (S, S) score matrix
        o = attn_lib.gqa_attention_chunked(q, k, v, causal=True, q_chunk=cfg.attn_chunk // 4)
    else:
        o = attn_lib.gqa_attention(q, k, v, causal=True)
    if mode == "prefill":
        _fit_cache(cache["k"], k)
        _fit_cache(cache["v"], v)
    return _heads_out(o, p["wo"])


class EncDecLM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if not cfg.encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters on the model's device, drawn from ``gen``, a
        ``torch.Generator`` on that device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        return {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
                "enc_pos": embed_init(gen, (cfg.enc_seq, cfg.d_model), dtype),
                "enc": _init_enc_layers(gen, cfg, dtype, cfg.n_enc_layers),
                "dec": _init_dec_layers(gen, cfg, dtype, cfg.n_layers),
                "ln_enc": zeros((cfg.d_model,), gen.device),
                "ln_f": zeros((cfg.d_model,), gen.device)}

    # -- encoder ------------------------------------------------------------------
    def encode(self, params: Params, frames: torch.Tensor, remat: str = "full") -> torch.Tensor:
        """frames (B, T, D), T <= enc_seq, in the model's dtype → the encoder
        output (B, T, D). Frames of another dtype raise a ``TypeError``: the
        JAX package adds bf16 positions to float32 frames, carries the sum in
        float32 and then fails in its layer scan, so no result of its exists
        to cast towards."""
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        if frames.dtype != dtype:
            raise TypeError(f"{cfg.name}: encoder frames are {frames.dtype}, the model "
                            f"computes in {dtype}; pass frames in {dtype}")
        x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
        x = maybe_shard(x, RESIDUAL)
        for p in _unbind(params["enc"], cfg.n_enc_layers):
            if remat == "full" and torch.is_grad_enabled():
                x = checkpoint(self._enc_layer, x, p, use_reentrant=False)
            else:
                x = self._enc_layer(x, p)
        return maybe_shard(rms_norm(x, params["ln_enc"], cfg.norm_eps), GATHERED)

    def _enc_layer(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        eps = self.cfg.norm_eps
        x = _add(x, _attn_noncausal(p["attn"], _normed(x, p["ln1"], eps)))
        return _add(x, apply_mlp(p["mlp"], _normed(x, p["ln2"], eps), self.cfg.act))

    # -- decoder (train) ------------------------------------------------------------
    def apply(self, params: Params, tokens: torch.Tensor, *, encoder_frames: torch.Tensor,
              remat: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S), encoder_frames (B, T, D) → (logits (B, S, V) f32, a
        float32 zero aux loss). ``remat="full"`` recomputes each encoder and
        decoder layer in the backward, as the JAX package wraps each in
        ``jax.remat``; ``"none"`` keeps every activation."""
        if remat not in ("full", "none"):
            raise ValueError(f"remat={remat!r}: 'full' or 'none'")
        cfg = self.cfg
        params = gathered_table(params)
        enc_out = self.encode(params, encoder_frames, remat)
        x = maybe_shard(F.embedding(tokens.long(), params["embed"]), RESIDUAL)
        for p in _unbind(params["dec"], cfg.n_layers):
            if remat == "full" and torch.is_grad_enabled():
                x = checkpoint(self._dec_layer, x, p, enc_out, use_reentrant=False)
            else:
                x = self._dec_layer(x, p, enc_out)
        x = maybe_shard(rms_norm(x, params["ln_f"], cfg.norm_eps), GATHERED)
        logits = head(cfg, params, x)
        return logits, replicate_like(torch.zeros((), device=x.device), logits)

    def _dec_layer(self, x: torch.Tensor, p: Params, enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _add(x, _self_attn(p["self_attn"], _normed(x, p["ln1"], cfg.norm_eps), cfg,
                               mode="train", cache=None, pos=None))
        k, v = _cross_kv(p["cross_attn"], enc_out)
        x = _add(x, _cross_attn(p["cross_attn"], _normed(x, p["ln_x"], cfg.norm_eps), k, v))
        return _add(x, apply_mlp(p["mlp"], _normed(x, p["ln2"], cfg.norm_eps), cfg.act))

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *, remat: str = "full"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The mean next-token NLL over every label position (the reference
        takes no ``mask`` here): ``(nll, {"nll", "aux"})``."""
        logits, aux = self.apply(params, batch["tokens"], remat=remat,
                                 encoder_frames=batch["encoder_frames"])
        labels = batch["labels"].long()
        nll = torch.mean(token_nll(logits, labels, torch.ones_like(labels, dtype=logits.dtype)))
        return nll, {"nll": nll, "aux": aux}

    # -- serving --------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        """The decoder's self-attention K/V (L, B, max_len, KV, hd) and the
        cross-attention K/V of the encoder output (L, B, enc_seq, KV, hd)."""
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

        def z(t: int) -> Params:
            return {n: zeros((L, batch, t, kv, hd), self.device, dtype) for n in ("k", "v")}
        return {"self": z(max_len), "cross": z(cfg.enc_seq)}

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params, *,
                encoder_frames: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """Encode ``encoder_frames`` (B, enc_seq, D) into the cross cache,
        prefill the decoder's self cache with ``tokens``: the last
        position's logits (B, 1, V). Under a mesh the stream is laid out at
        the reference's sites (``src/repro/models/encdec.py`` prefill), the
        cross cache written in its ``cache_specs`` layout."""
        cfg = self.cfg
        eps = cfg.norm_eps
        cross = cache["cross"]
        if encoder_frames.shape[1] != cross["k"].shape[2]:
            raise ValueError(f"{cfg.name}: {encoder_frames.shape[1]} encoder frames, the cross "
                             f"cache holds {cross['k'].shape[2]}")
        params = gathered_table(params)
        enc_out = self.encode(params, encoder_frames, remat="none")
        x = maybe_shard(F.embedding(tokens.long(), params["embed"]), RESIDUAL)
        for i in range(cfg.n_layers):
            p, c = _layer(params["dec"], i), _layer(cross, i)
            k, v = _cross_kv(p["cross_attn"], enc_out)
            _fit_cache(c["k"], k)
            _fit_cache(c["v"], v)
            x = _add(x, _self_attn(p["self_attn"], _normed(x, p["ln1"], eps), cfg,
                                   mode="prefill", cache=_layer(cache["self"], i), pos=None))
            x = _add(x, _cross_attn(p["cross_attn"], _normed(x, p["ln_x"], eps), k, v))
            x = _add(x, apply_mlp(p["mlp"], _normed(x, p["ln2"], eps), cfg.act))
        x = _normed(x, params["ln_f"], eps)
        return head(cfg, params, x[:, -1:]), cache

    def decode(self, params: Params, token: torch.Tensor, cache: Params,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """token (B, 1); pos (B,) — uniform position of the new token. Under
        a mesh the stream is laid out by batch (the reference's decode
        sites), and the cross-attention reads each rank's frames of the
        cross cache (``_cross_attn_decode``)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        params = gathered_table(params)
        token = maybe_shard(token, P(BATCH, None))        # a greedy token as the prompt
        x = maybe_shard(F.embedding(token.long(), params["embed"]), GATHERED)
        for i in range(cfg.n_layers):
            p, cross = _layer(params["dec"], i), _layer(cache["cross"], i)
            x = _add(x, _self_attn(p["self_attn"], _normed(x, p["ln1"], eps), cfg,
                                   mode="decode", cache=_layer(cache["self"], i), pos=pos))
            x = _add(x, _cross_attn_decode(p["cross_attn"], _normed(x, p["ln_x"], eps),
                                           cross["k"], cross["v"]))
            x = _add(x, apply_mlp(p["mlp"], _normed(x, p["ln2"], eps), cfg.act))
        x = _normed(x, params["ln_f"], eps)
        return head(cfg, params, x), cache
