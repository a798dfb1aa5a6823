"""Decoder-only language model: dense GQA, Mamba-2 and RecurrentGemma
paths (PyTorch counterpart of ``repro.models.transformer``).

One ``LM`` object per ``ArchConfig`` exposes:

    init(gen)                          → params
    apply(params, tokens, remat=)      → (logits, aux)   (train / eval)
    loss(params, batch, remat=)        → (loss, {"nll", "aux"})
    init_cache(batch, max_len)         → cache
    prefill(params, tokens, cache)     → (logits, cache)
    decode(params, token, cache, pos)  → (logits, cache)

Parameters and caches are nested dicts of tensors with the JAX package's
tree layout: layers are grouped into a repeated unit (``scan_groups``),
whose ``params["stack"]["u0".."uk"]`` leaves carry a leading
``(n_units, ...)`` axis, plus an unstacked remainder
``params["tail"]["t0".."tm"]`` (RecurrentGemma's 2:1 pattern over 38
layers). Layer ``i`` of the stack runs on views ``leaf[i]``. Unlike the
JAX package, prefill and decode write the caches (KV rings, SSM and
RG-LRU states, conv tails) in place through those views and return the
same cache object, so serving holds one cache in device memory and never
copies it.

Layer kinds ported: ``dense``, ``ssm`` (Mamba-2), ``rec`` (RG-LRU) and
``local_attn``; MoE, MLA, encoder-decoder and the VLM prefix raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_lib
from .common import (apply_rope, dense_init, dtype_of, embed_init, resolve_device,
                     rms_norm, zeros)
from .config import ArchConfig
from .mlp import apply_mlp, init_mlp
from .rglru import apply_rglru, init_rglru, rglru_state_shape
from .ssm import apply_mamba2, apply_mamba2_decode, init_mamba2, mamba2_state_shape

Params = Dict[str, Any]


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` cannot run on the port yet, or None when it can."""
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
    """kind ∈ {dense, ssm, rec, local_attn}."""
    p: Params = {"ln1": zeros(lead + (cfg.d_model,), gen.device)}
    if kind == "ssm":
        p["mixer"] = init_mamba2(gen, cfg, dtype, lead)
        return p
    if kind == "rec":
        p["mixer"] = init_rglru(gen, cfg, dtype, lead)
    elif kind in ("dense", "local_attn"):
        p["mixer"] = init_attn(gen, cfg, dtype, lead)
    else:
        raise NotImplementedError(f"layer kind {kind!r}: {unsupported(cfg)}")
    p["ln2"] = zeros(lead + (cfg.d_model,), gen.device)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, lead)
    return p


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


def _store(cache: Params, new: Dict[str, torch.Tensor]) -> None:
    """Write a recurrent layer's new state into its cache views in place."""
    for name, value in new.items():
        cache[name].copy_(value)


def apply_block(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                mode: str = "train", cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        if mode == "decode":
            y, new = apply_mamba2_decode(p["mixer"], h, cfg, cache)
        else:
            y, new = apply_mamba2(p["mixer"], h, cfg, None)
        if mode != "train":
            _store(cache, new)
        return x + y
    if kind == "rec":
        y, new = apply_rglru(p["mixer"], h, cfg, cache if mode == "decode" else None)
        if mode != "train":
            _store(cache, new)
    elif kind in ("dense", "local_attn"):
        window = (cfg.window or 2048) if kind == "local_attn" else cfg.window
        y = apply_attn(p["mixer"], h, cfg, mode=mode, cache=cache, pos=pos, window=window)
    else:
        raise NotImplementedError(f"layer kind {kind!r}: {unsupported(cfg)}")
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h2, cfg.act)


def _layer(tree: Union[Params, torch.Tensor], i: int):
    """Layer ``i`` of a stacked tree, as views into the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree: Union[Params, torch.Tensor], n: int):
    """The ``n`` layers of a stacked tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients once, where ``n`` selects would
    each add a full-size zero gradient."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


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

    # -- structure ------------------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        cfg = self.cfg
        if cfg.ssm:
            return ("ssm",) * cfg.n_layers
        if cfg.block_pattern:
            pat = cfg.block_pattern
            return tuple(pat[i % len(pat)] for i in range(cfg.n_layers))
        return ("dense",) * cfg.n_layers

    def scan_groups(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(unit_pattern, n_units, tail_kinds): layers = unit×n + tail."""
        kinds = self.layer_kinds()
        cfg = self.cfg
        if cfg.block_pattern:
            u = len(cfg.block_pattern)
            n_units = cfg.n_layers // u
            return tuple(cfg.block_pattern), n_units, kinds[n_units * u:]
        return (kinds[0],), cfg.n_layers, ()

    def _layers(self, params: Params, cache: Optional[Params] = None
                ) -> Iterator[Tuple[str, Params, Optional[Params]]]:
        """(kind, layer params, layer cache) in execution order: the stacked
        units (as views into the stacked tensors), then the tail."""
        unit, n_units, tail = self.scan_groups()
        for u in range(n_units):
            for i, kind in enumerate(unit):
                yield (kind, _layer(params["stack"][f"u{i}"], u),
                       None if cache is None else _layer(cache["stack"][f"u{i}"], u))
        for i, kind in enumerate(tail):
            yield (kind, params["tail"][f"t{i}"],
                   None if cache is None else cache["tail"][f"t{i}"])

    # -- init -------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters on the model's device, drawn from ``gen``, a
        ``torch.Generator`` on that device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        unit, n_units, tail = self.scan_groups()
        params: Params = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
            "ln_f": zeros((cfg.d_model,), gen.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype)
        params["stack"] = {f"u{i}": init_block(gen, cfg, kind, dtype, lead=(n_units,))
                           for i, kind in enumerate(unit)}
        if tail:
            params["tail"] = {f"t{i}": init_block(gen, cfg, kind, dtype)
                              for i, kind in enumerate(tail)}
        return params

    # -- caches -------------------------------------------------------------------
    def _block_cache_shape(self, kind: str, batch: int, max_len: int, dtype):
        cfg = self.cfg
        if kind == "ssm":
            return mamba2_state_shape(cfg, batch, dtype)
        if kind == "rec":
            return rglru_state_shape(cfg, batch, dtype)
        cache_len = max_len
        if kind == "local_attn" or (cfg.window and not cfg.block_pattern):
            cache_len = min(max_len, (cfg.window or max_len))
        return {"k": ((batch, cache_len, cfg.n_kv_heads, cfg.hd), dtype),
                "v": ((batch, cache_len, cfg.n_kv_heads, cfg.hd), dtype)}

    def init_cache(self, batch: int, max_len: int) -> Params:
        dtype = dtype_of(self.cfg.dtype)
        unit, n_units, tail = self.scan_groups()

        def alloc(kind: str, lead: Tuple[int, ...]) -> Params:
            return {name: zeros(lead + shape, self.device, dt) for name, (shape, dt)
                    in self._block_cache_shape(kind, batch, max_len, dtype).items()}
        cache: Params = {"stack": {f"u{i}": alloc(kind, (n_units,))
                                   for i, kind in enumerate(unit)}}
        if tail:
            cache["tail"] = {f"t{i}": alloc(kind, ()) for i, kind in enumerate(tail)}
        return cache

    # -- forward (train/eval) -------------------------------------------------------
    def apply(self, params: Params, tokens: torch.Tensor, *, remat: str = "full"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) → (logits (B, S, V) f32, aux_loss).

        ``remat="full"`` recomputes each stacked unit in the backward
        (``torch.utils.checkpoint``, non-reentrant), as the JAX package wraps
        each scanned unit in ``jax.remat``; ``"none"`` keeps every
        activation. The JAX ``"dots"`` policy (keep the products without
        batch dimensions) has no one-line torch counterpart and raises."""
        if remat == "dots":
            raise NotImplementedError(
                "remat='dots' (jax.checkpoint_dots_with_no_batch_dims) is not ported "
                "(ROADMAP: Queue 1 item 1, 'Training'); use 'full' or 'none'")
        if remat not in ("full", "none"):
            raise ValueError(f"remat={remat!r}: 'full' or 'none'")
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        unit, n_units, tail = self.scan_groups()
        for unit_params in _unbind(params["stack"], n_units):
            if remat == "full" and torch.is_grad_enabled():
                x = checkpoint(self._unit_apply, x, unit_params, use_reentrant=False)
            else:
                x = self._unit_apply(x, unit_params)
        for i, kind in enumerate(tail):
            x = apply_block(params["tail"][f"t{i}"], x, cfg, kind, mode="train")
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x), torch.zeros((), device=x.device)

    def _unit_apply(self, x: torch.Tensor, unit_params: Params) -> torch.Tensor:
        unit = self.scan_groups()[0]
        for i, kind in enumerate(unit):
            x = apply_block(unit_params[f"u{i}"], x, self.cfg, kind, mode="train")
        return x

    # -- loss ----------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *, remat: str = "full"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token NLL over the ``mask``ed label positions (all when
        no ``mask``) plus the aux loss: ``(loss, {"nll", "aux"})``."""
        logits, aux = self.apply(params, batch["tokens"], remat=remat)
        nll = self._nll(logits, batch)
        return nll + aux, {"nll": nll, "aux": aux}

    def loss_from_hidden(self, params: Params, x: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The mean NLL from the layer stack's output ``x`` (B, S, D) on, as
        ``loss`` takes it from there (final norm, head, NLL): the loss of a
        pipeline executor's output."""
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return self._nll(self._head(params, x), batch)

    def _nll(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        labels = batch["labels"].long()
        if logits.shape[1] != labels.shape[1]:      # prefix rows carry no loss
            logits = logits[:, -labels.shape[1]:]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        return torch.sum((lse - ll) * mask) / torch.clamp(torch.sum(mask), min=1.0)

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
        for kind, p, c in self._layers(params, cache):
            x = apply_block(p, x, cfg, kind, mode=mode, cache=c, pos=pos)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return self._head(params, x[:, -1:]), cache
