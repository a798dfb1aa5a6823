"""Decoder-only language model, dense GQA path (PyTorch counterpart of
``repro.models.transformer``).

One ``LM`` object per ``ArchConfig`` exposes:

    init(gen)                          → params
    apply(params, tokens)              → (logits, aux)   (train / eval)
    init_cache(batch, max_len)         → cache
    prefill(params, tokens, cache)     → (logits, cache)
    decode(params, token, cache, pos)  → (logits, cache)

Parameters and caches are nested dicts of tensors with the JAX package's
tree layout, the layer stack included: ``params["stack"]["u0"][...]``
leaves carry a leading ``(n_layers, ...)`` axis, and layer ``i`` runs on
views ``leaf[i]``. Unlike the JAX package, prefill and decode write the
KV cache in place (through those views) and return the same cache object,
so serving holds one cache in device memory and never copies it.

Only ``dense`` layers are ported; other layer kinds raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from . import attention as attn_lib
from .common import (apply_rope, dense_init, dtype_of, embed_init, resolve_device,
                     rms_norm, zeros)
from .config import ArchConfig
from .mlp import apply_mlp, init_mlp

Params = Dict[str, Any]


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` cannot run on the port yet, or None for a dense model."""
    if cfg.ssm:
        return "ssm layers (ROADMAP: Queue 1 'Mamba-2', Queue 2 'ssd_scan')"
    if cfg.block_pattern:
        return "rec / local_attn layers (ROADMAP: Queue 1 'RecurrentGemma', Queue 2 'rglru_scan')"
    if cfg.mla:
        return "MLA attention (ROADMAP: Queue 1 'MLA')"
    if cfg.n_experts:
        return "moe layers (ROADMAP: Queue 1 'MoE')"
    if cfg.encdec:
        return "encoder-decoder (ROADMAP: Queue 1 'Encoder-decoder and VLM prefix')"
    if cfg.vision_stub or cfg.prefix_len:
        return "VLM prefix (ROADMAP: Queue 1 'Encoder-decoder and VLM prefix')"
    return None


# ==============================================================================
# per-layer init
# ==============================================================================
def init_attn(gen: torch.Generator, cfg: ArchConfig, dtype,
              lead: Tuple[int, ...] = ()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": dense_init(gen, (d, h, hd), dtype, lead=lead),
         "wk": dense_init(gen, (d, kv, hd), dtype, lead=lead),
         "wv": dense_init(gen, (d, kv, hd), dtype, lead=lead),
         "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd, lead=lead)}
    if cfg.qk_norm:
        p["q_norm"] = zeros(lead + (hd,), gen.device)
        p["k_norm"] = zeros(lead + (hd,), gen.device)
    return p


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               lead: Tuple[int, ...] = ()) -> Params:
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r}: {unsupported(cfg)}")
    return {"ln1": zeros(lead + (cfg.d_model,), gen.device),
            "mixer": init_attn(gen, cfg, dtype, lead),
            "ln2": zeros(lead + (cfg.d_model,), gen.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, lead)}


# ==============================================================================
# per-layer apply (mode: train | prefill | decode)
# ==============================================================================
def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:                   # qk-norm comes before rope
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attn(p: Params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[Params], pos: Optional[torch.Tensor],
               window: Optional[int]) -> torch.Tensor:
    B, S, _ = x.shape
    if mode == "decode":
        positions = pos[:, None] if pos.ndim == 1 else pos
        q, k, v = _project_qkv(p, x, cfg, positions)
        kc, vc = cache["k"], cache["v"]
        t_buf = kc.shape[1]
        ring = window is not None and t_buf <= window
        slot = pos % t_buf if ring else pos
        _write_cache(kc, k, slot)
        _write_cache(vc, v, slot)
        if ring:
            # ring holds exactly the in-window tokens; no window re-mask
            valid = torch.clamp(pos + 1, max=t_buf)
            o = attn_lib.decode_attention(q, kc, vc, valid, window=None)
        else:
            o = attn_lib.decode_attention(q, kc, vc, pos + 1, window=window)
        return torch.einsum("bshk,hkd->bsd", o, p["wo"])

    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if S > cfg.attn_chunk:
        o = attn_lib.gqa_attention_chunked(q, k, v, causal=True, window=window,
                                           q_chunk=cfg.attn_chunk // 4)
    else:
        o = attn_lib.gqa_attention(q, k, v, causal=True, window=window)
    if mode == "prefill":
        _fit_cache(cache["k"], k)
        _fit_cache(cache["v"], v)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _write_cache(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor) -> None:
    """Write (B,1,KV,hd) in place at position ``pos[0]`` (uniform over the
    batch; clamped into the buffer as ``dynamic_update_slice`` does). The
    index stays on the device, so decode never waits on the host."""
    idx = pos[:1].clamp(0, cache.shape[1] - 1).long()
    cache.index_copy_(1, idx, kv.to(cache.dtype))


def _fit_cache(cache: torch.Tensor, kv: torch.Tensor) -> None:
    """Place prefill K/V into the cache buffer in place. When the prefill is
    longer than a (windowed) ring buffer, keep the last T_buf entries laid
    out at their ring slots (slot = absolute_pos % T_buf)."""
    t_buf, s = cache.shape[1], kv.shape[1]
    if s <= t_buf:
        cache[:, :s].copy_(kv)
    else:
        cache.copy_(torch.roll(kv[:, -t_buf:], s % t_buf, dims=1))


def apply_block(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                mode: str = "train", cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r}: {unsupported(cfg)}")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + apply_attn(p["mixer"], h, cfg, mode=mode, cache=cache, pos=pos,
                       window=cfg.window)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h2, cfg.act)


def _layer(tree: Union[Params, torch.Tensor], i: int):
    """Layer ``i`` of a stacked tree, as views into the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ==============================================================================
# the LM
# ==============================================================================
class LM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        reason = unsupported(cfg)
        if reason is not None:
            raise NotImplementedError(f"{cfg.name}: {reason}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- init -------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters on the model's device, drawn from ``gen``, a
        ``torch.Generator`` on that device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        params: Params = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
            "ln_f": zeros((cfg.d_model,), gen.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype)
        params["stack"] = {"u0": init_block(gen, cfg, "dense", dtype, lead=(cfg.n_layers,))}
        return params

    # -- caches -------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        cfg = self.cfg
        cache_len = min(max_len, cfg.window) if cfg.window else max_len
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        dtype = dtype_of(cfg.dtype)
        return {"stack": {"u0": {"k": zeros(shape, self.device, dtype),
                                 "v": zeros(shape, self.device, dtype)}}}

    # -- forward (train/eval) -------------------------------------------------------
    def apply(self, params: Params, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) → (logits (B, S, V) f32, aux_loss)."""
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        for i in range(cfg.n_layers):
            x = apply_block(_layer(params["stack"]["u0"], i), x, cfg, "dense", mode="train")
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x), torch.zeros((), device=x.device)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        logits = (x @ w).float()
        if cfg.padded_vocab != cfg.vocab_size:
            live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
            logits = logits + torch.where(live, 0.0, attn_lib.NEG_INF)
        return logits

    # -- prefill / decode -------------------------------------------------------------
    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params
                ) -> Tuple[torch.Tensor, Params]:
        return self._serve(params, tokens, cache, mode="prefill", pos=None)

    def decode(self, params: Params, token: torch.Tensor, cache: Params,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """token (B, 1); pos (B,) — uniform position of the new token."""
        return self._serve(params, token, cache, mode="decode", pos=pos)

    def _serve(self, params: Params, tokens: torch.Tensor, cache: Params, *,
               mode: str, pos: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        for i in range(cfg.n_layers):
            x = apply_block(_layer(params["stack"]["u0"], i), x, cfg, "dense", mode=mode,
                            cache=_layer(cache["stack"]["u0"], i), pos=pos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x[:, -1:]), cache
