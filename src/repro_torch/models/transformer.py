"""Decoder-only language model: dense GQA, Mixture-of-Experts, DeepSeek's
multi-head latent attention, Mamba-2 and RecurrentGemma paths (PyTorch
counterpart of ``repro.models.transformer``).

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
layers, DeepSeek's leading dense layers). The tail runs after the stack,
except in an MoE model with leading dense layers, where it runs first.
Layer ``i`` of the stack runs on views ``leaf[i]``. Unlike the JAX
package, prefill and decode write the caches (KV rings, MLA latents, SSM
and RG-LRU states, conv tails) in place through those views and return
the same cache object, so serving holds one cache in device memory and
never copies it.

Layer kinds ported: ``dense``, ``moe`` and ``dense_mlp`` (attention or
MLA, then an MoE or a dense MLP), ``ssm`` (Mamba-2), ``rec`` (RG-LRU) and
``local_attn``. The VLM prefix (PaliGemma) is ``extra_embeddings`` (B, P,
D) prepended to the token embeddings, attending bidirectionally over the
first ``prefix_len`` positions: ``apply`` starts from ``prefix_len=0``,
``prefill`` from ``cfg.prefix_len``, each raised to P, as in the JAX
package. The encoder-decoder is ``models.encdec.EncDecLM``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn_lib
from .attention import heads_in, heads_out
from .common import (apply_rope, dense_init, dtype_of, embed_init, resolve_device,
                     rms_norm, zeros)
from .config import ArchConfig
from .mlp import apply_mlp, apply_moe, init_mlp, init_moe
from .rglru import apply_rglru, init_rglru, rglru_state_shape
from .sharding_utils import (BATCH, P, is_dtensor, key_shard, layer_view, maybe_shard, moved,
                             on_shards, relayout, replicate_like, rows_of, summed)
from .ssm import apply_mamba2, apply_mamba2_decode, init_mamba2, mamba2_state_shape

Params = Dict[str, Any]


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` cannot run on the port yet, or None when it can: every
    family of the JAX package runs (the encoder-decoder through
    ``models.encdec.EncDecLM``, which ``build_model`` picks)."""
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


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (d, rq), dtype, lead=lead),
        "q_norm": zeros(lead + (rq,), gen.device),
        "wq_nope": dense_init(gen, (rq, h, dn), dtype, fan_in=rq, lead=lead),
        "wq_rope": dense_init(gen, (rq, h, dr), dtype, fan_in=rq, lead=lead),
        "wkv_a": dense_init(gen, (d, rkv + dr), dtype, lead=lead),
        "kv_norm": zeros(lead + (rkv,), gen.device),
        "wk_nope": dense_init(gen, (rkv, h, dn), dtype, fan_in=rkv, lead=lead),
        "wv": dense_init(gen, (rkv, h, dv), dtype, fan_in=rkv, lead=lead),
        "wo": dense_init(gen, (h, dv, d), dtype, fan_in=h * dv, lead=lead),
    }


ATTN_KINDS = ("dense", "moe", "dense_mlp")


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               lead: Tuple[int, ...] = ()) -> Params:
    """kind ∈ {dense, moe, dense_mlp, ssm, rec, local_attn}."""
    p: Params = {"ln1": zeros(lead + (cfg.d_model,), gen.device)}
    if kind == "ssm":
        p["mixer"] = init_mamba2(gen, cfg, dtype, lead)
        return p
    if kind == "rec":
        p["mixer"] = init_rglru(gen, cfg, dtype, lead)
    elif kind in ATTN_KINDS + ("local_attn",):
        p["mixer"] = (init_mla if cfg.mla else init_attn)(gen, cfg, dtype, lead)
    else:
        raise ValueError(f"layer kind {kind!r}")
    p["ln2"] = zeros(lead + (cfg.d_model,), gen.device)
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, lead)
    return p


# ==============================================================================
# per-layer apply (mode: train | prefill | decode)
# ==============================================================================
# the residual stream's layout between blocks under a mesh (the reference's
# P(("pod","data"), "model", None)), and the same gathered over the sequence
RESIDUAL = P(BATCH, "model", None)
GATHERED = P(BATCH, None, None)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = heads_in(x, p["wq"])
    k = heads_in(x, p["wk"])
    v = heads_in(x, p["wv"])
    if cfg.qk_norm:                   # qk-norm comes before rope
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attn(p: Params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
               cache: Optional[Params], pos: Optional[torch.Tensor],
               window: Optional[int], prefix_len: int = 0) -> torch.Tensor:
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
        return heads_out(o, p["wo"])

    positions = torch.arange(S, device=x.device)[None, :]
    # under a mesh the residual stream is sequence-sharded over "model" and
    # the projections head-sharded: gather the sequence first (as before the
    # MLP and the head), so q, k and v come out head-sharded and each rank
    # attends its own heads
    x = maybe_shard(x, GATHERED)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if S > cfg.attn_chunk:
        o = attn_lib.gqa_attention_chunked(q, k, v, causal=True, window=window,
                                           prefix_len=prefix_len, q_chunk=cfg.attn_chunk // 4)
    else:
        o = attn_lib.gqa_attention(q, k, v, causal=True, window=window, prefix_len=prefix_len)
    if mode == "prefill":
        _fit_cache(cache["k"], k)
        _fit_cache(cache["v"], v)
    return heads_out(o, p["wo"])


def _cache_shard(cache) -> Tuple[int, Any]:
    """(this rank's first slot, the rows placements) of a cache DTensor laid
    out by ``cache_specs`` (its batch and its slots sharded, or whole)."""
    at = key_shard(cache)
    if at is None:
        raise ValueError(f"a serving cache laid out as {cache.placements}: cache_specs shards "
                         "only the batch and the sequence, evenly")
    return at[0], rows_of(cache)


def _write_cache(cache: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor) -> None:
    """Write (B,1,...) in place at position ``pos[0]`` (uniform over the
    batch; clamped into the buffer as ``dynamic_update_slice`` does). The
    index stays on the device, so decode never waits on the host. Under a
    mesh (a cache sharded over its slots by ``cache_specs``) every rank of
    a batch row gets the new row, and the rank whose shard holds the slot
    writes it: the local slot clamped into the shard, the old row kept by a
    select on the others."""
    if not is_dtensor(cache):
        idx = pos[:1].clamp(0, cache.shape[1] - 1).long()
        cache.index_copy_(1, idx, kv.to(cache.dtype))
        return
    offset, rows = _cache_shard(cache)
    local = cache.to_local()
    n = local.shape[1]
    new = relayout(summed(kv), moved(cache.placements, {1: None})).to_local()
    slot = relayout(replicate_like(pos, cache), rows).to_local()[:1]
    slot = slot.clamp(0, cache.shape[1] - 1) - offset
    own = ((slot >= 0) & (slot < n)).reshape((1,) * local.ndim)
    idx = slot.clamp(0, n - 1).long()
    local.index_copy_(1, idx, torch.where(own, new.to(local.dtype), local.index_select(1, idx)))


def _fit_cache(cache: torch.Tensor, kv: torch.Tensor) -> None:
    """Place prefill K/V into the cache buffer in place. When the prefill is
    longer than a (windowed) ring buffer, keep the last T_buf entries laid
    out at their ring slots (slot = absolute_pos % T_buf). Under a mesh the
    ring is rolled on each rank's whole sequence (its own heads), then the
    buffer laid out as the cache (the all-to-all from heads to slots), and
    each rank copies the prefill's slots of its shard."""
    t_buf, s = cache.shape[1], kv.shape[1]
    if not is_dtensor(cache):
        if s <= t_buf:
            cache[:, :s].copy_(kv)
        else:
            cache.copy_(torch.roll(kv[:, -t_buf:], s % t_buf, dims=1))
        return
    from torch.distributed.tensor import DTensor
    offset, _ = _cache_shard(cache)
    kv = summed(kv)
    kv = relayout(kv, moved(kv.placements, {1: None}))
    loc = kv.to_local().to(cache.dtype)
    if s <= t_buf:
        pad = loc.new_zeros(loc.shape[:1] + (t_buf - s,) + loc.shape[2:])
        buf = torch.cat([loc, pad], dim=1)
    else:
        buf = torch.roll(loc[:, -t_buf:], s % t_buf, dims=1)
    shape = cache.shape
    buf = DTensor.from_local(buf, cache.device_mesh, kv.placements, run_check=False,
                             shape=shape, stride=torch.empty(shape, device="meta").stride())
    local = cache.to_local()
    n = min(max(min(s, t_buf) - offset, 0), local.shape[1])
    local[:, :n].copy_(relayout(buf, cache.placements).to_local()[:, :n])


def apply_mla_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                    cache: Optional[Params], pos: Optional[torch.Tensor]) -> torch.Tensor:
    S = x.shape[1]
    # under a mesh: the sequence gathered (as GQA's projections take it), and
    # the Rq-sharded query latent gathered over "model" before its norm; each
    # rank then attends its own heads (``mla_prefill``)
    x = maybe_shard(x, GATHERED)
    cq = rms_norm(maybe_shard(x @ p["wq_a"], GATHERED), p["q_norm"], cfg.norm_eps)
    kv_a = x @ p["wkv_a"]
    ckv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    if mode == "decode":
        k_rope_rot = apply_rope(k_rope[:, :, None, :], pos[:, None], cfg.rope_theta)[:, :, 0]
        _write_cache(cache["ckv"], ckv, pos)
        _write_cache(cache["krope"], k_rope_rot, pos)
        o = attn_lib.mla_decode(cq, cache["ckv"], cache["krope"], pos + 1,
                                p["wq_nope"], p["wq_rope"], p["wk_nope"], p["wv"],
                                rope_theta=cfg.rope_theta)
        return heads_out(o, p["wo"])
    o = attn_lib.mla_prefill(cq, ckv, k_rope, p["wq_nope"], p["wq_rope"], p["wk_nope"],
                             p["wv"], rope_theta=cfg.rope_theta,
                             q_chunk=cfg.attn_chunk // 4 if S > cfg.attn_chunk else None)
    if mode == "prefill":
        positions = torch.arange(S, device=x.device)[None, :]
        k_rope_rot = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
        _fit_cache(cache["ckv"], ckv)
        _fit_cache(cache["krope"], k_rope_rot)
    return heads_out(o, p["wo"])


def _store(cache: Params, new: Dict[str, torch.Tensor]) -> None:
    """Write a recurrent layer's new state into its cache views in place;
    under a mesh the state is laid out as its cache first (``cache_specs``:
    by batch)."""
    for name, value in new.items():
        c = cache[name]
        if is_dtensor(c):
            c.to_local().copy_(relayout(summed(replicate_like(value, c)),
                                        c.placements).to_local())
        else:
            c.copy_(value)


def apply_block(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                mode: str = "train", cache: Optional[Params] = None,
                pos: Optional[torch.Tensor] = None, prefix_len: int = 0) -> torch.Tensor:
    """One layer: the residual stream after it (an MoE layer's aux loss is
    dropped; ``apply_block_aux`` returns it)."""
    return apply_block_aux(p, x, cfg, kind, mode=mode, cache=cache, pos=pos,
                           prefix_len=prefix_len)[0]


def apply_block_aux(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                    mode: str = "train", cache: Optional[Params] = None,
                    pos: Optional[torch.Tensor] = None, prefix_len: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: (the residual stream after it, its aux loss: an MoE
    layer's load-balance loss, else a float32 zero). ``prefix_len`` reaches
    GQA attention only (the reference's MLA takes none)."""
    aux = replicate_like(torch.zeros((), device=x.device), x)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        if mode == "decode":
            y, new = apply_mamba2_decode(p["mixer"], h, cfg, cache)
        else:
            y, new = apply_mamba2(p["mixer"], h, cfg, None)
        if mode != "train":
            _store(cache, new)
        # laid out as the residual stream before the add (as the other
        # branches below), so its gradient comes back in y's own layout:
        # the sequence-sharded one reached out_proj's weight gradient
        # flattened over (batch, sequence) and DTensor's product refused it
        return maybe_shard(x + maybe_shard(y, RESIDUAL), RESIDUAL), aux
    if kind == "rec":
        y, new = apply_rglru(p["mixer"], h, cfg, cache if mode == "decode" else None)
        if mode != "train":
            _store(cache, new)
    elif cfg.mla and kind in ATTN_KINDS:
        y = apply_mla_block(p["mixer"], h, cfg, mode=mode, cache=cache, pos=pos)
    elif kind in ATTN_KINDS + ("local_attn",):
        window = (cfg.window or 2048) if kind == "local_attn" else cfg.window
        y = apply_attn(p["mixer"], h, cfg, mode=mode, cache=cache, pos=pos, window=window,
                       prefix_len=prefix_len)
    else:
        raise ValueError(f"layer kind {kind!r}")
    # under a mesh each branch's output is laid out as the residual stream
    # before the add (a reduce-scatter of the row-parallel products), so its
    # gradient comes back gathered to the products' backward
    x = x + maybe_shard(y, RESIDUAL)
    h2 = maybe_shard(rms_norm(x, p["ln2"], cfg.norm_eps), GATHERED)
    if kind == "moe":
        y2, aux = apply_moe(p["moe"], h2, cfg)
    else:
        y2 = apply_mlp(p["mlp"], h2, cfg.act)
    x = x + maybe_shard(y2, RESIDUAL)
    return maybe_shard(x, RESIDUAL), aux


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each position's masked NLL: (logsumexp - the label's logit) * mask."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - ll) * mask


def token_nll(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``_token_nll``; under a mesh the (vocab-sharded) logits are laid out by
    sequence, as the residual stream, and each rank takes its own tokens'."""
    if not is_dtensor(logits):
        return _token_nll(logits, labels, mask)
    logits, labels, mask = (maybe_shard(t, RESIDUAL[:t.ndim]) for t in (logits, labels, mask))
    pl = tuple(labels.placements)
    return on_shards(_token_nll, (logits, labels, mask), ins=(tuple(logits.placements), pl, pl),
                     outs=pl)


def head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """float32 logits of the final-normed ``x``, the padded vocabulary's
    columns at -inf."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = logits + replicate_like(torch.where(live, 0.0, attn_lib.NEG_INF), logits)
    return logits


def gathered_table(params: Params) -> Params:
    """``params`` with the embedding table gathered over the batch axes (its
    vocab kept over "model") under a mesh, once a forward, as FSDP gathers a
    weight before use; ``params`` itself when unsharded. torch 2.11's DTensor
    looks tokens up in a table sharded on d by moving the tokens and then
    masks the output with the unmoved tokens (an IndexError on four cards at
    (2, 2)); and a tied table's two gradients, the lookup's and the head's,
    then add in one layout (2.11 cannot bring the head's, sharded on d, to
    the lookup's pending sum). One reduce-scatter returns the table's
    gradient to its layout."""
    if not is_dtensor(params["embed"]):
        return params
    return dict(params, embed=maybe_shard(params["embed"], P("model", None)))


def _prepend(x: torch.Tensor, extra: Optional[torch.Tensor], prefix_len: int
             ) -> Tuple[torch.Tensor, int]:
    """The token embeddings ``x`` with ``extra`` (B, P, D) prepended in
    their dtype, and ``prefix_len`` raised to P. Under a mesh both are laid
    out alike first, the sequence whole (the table's vocab-sharded lookup
    summed), so the concatenation is each rank's own."""
    if extra is None:
        return x, prefix_len
    x, extra = maybe_shard(x, GATHERED), maybe_shard(extra.to(x.dtype), GATHERED)
    return torch.cat([extra, x], dim=1), max(prefix_len, extra.shape[1])


# the products without batch dimensions: every projection is a 2-D product
# (``attention.heads_in``, ``_heads_out``, the MLPs' and the router's
# ``x @ W``), which dispatches to ``aten.mm``; scores, the MoE experts' and
# the scans' products carry batch dims and go to ``aten.bmm`` (einsum), the
# kernels to their own ops
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``'s policy, ``jax.checkpoint_dots_with_no_batch_dims``:
    keep the output of a product without batch dims (``aten.mm``,
    ``aten.addmm``), recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if func in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def rematted(fn, remat: str):
    """``fn`` as ``remat`` runs it where grad is enabled: ``"full"``
    recomputed in the backward (non-reentrant ``torch.utils.checkpoint``),
    ``"dots"`` recomputed but for its products without batch dims
    (``dots_policy``), ``"none"`` (or no grad) as it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, dots_policy)}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _layer(tree: Union[Params, torch.Tensor], i: int):
    """Layer ``i`` of a stacked tree, as views into the stacked tensors (a
    DTensor's of its local tensor, ``layer_view``)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return layer_view(tree, i) if is_dtensor(tree) else tree[i]


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
        if cfg.n_experts:
            return ("dense_mlp",) * cfg.n_dense_layers + \
                ("moe",) * (cfg.n_layers - cfg.n_dense_layers)
        return ("dense",) * cfg.n_layers

    def scan_groups(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(unit_pattern, n_units, tail_kinds): layers = unit×n + tail."""
        kinds = self.layer_kinds()
        cfg = self.cfg
        if cfg.block_pattern:
            u = len(cfg.block_pattern)
            n_units = cfg.n_layers // u
            return tuple(cfg.block_pattern), n_units, kinds[n_units * u:]
        if cfg.n_experts and cfg.n_dense_layers:
            nd = cfg.n_dense_layers
            return ("moe",), cfg.n_layers - nd, kinds[:nd]   # tail = leading dense
        return (kinds[0],), cfg.n_layers, ()

    @property
    def tail_first(self) -> bool:
        """Whether the tail runs before the stack (DeepSeek's leading dense
        layers) rather than after it."""
        return bool(self.cfg.n_experts and self.cfg.n_dense_layers)

    def _layers(self, params: Params, cache: Optional[Params] = None
                ) -> Iterator[Tuple[str, Params, Optional[Params]]]:
        """(kind, layer params, layer cache) in execution order: the stacked
        units (as views into the stacked tensors) and the tail, the tail
        first where ``tail_first``."""
        unit, n_units, tail = self.scan_groups()
        stacked = ((kind, _layer(params["stack"][f"u{i}"], u),
                    None if cache is None else _layer(cache["stack"][f"u{i}"], u))
                   for u in range(n_units) for i, kind in enumerate(unit))
        tailed = ((kind, params["tail"][f"t{i}"],
                   None if cache is None else cache["tail"][f"t{i}"])
                  for i, kind in enumerate(tail))
        first, then = (tailed, stacked) if self.tail_first else (stacked, tailed)
        yield from first
        yield from then

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
        if cfg.mla:
            return {"ckv": ((batch, max_len, cfg.kv_lora_rank), dtype),
                    "krope": ((batch, max_len, cfg.qk_rope_dim), dtype)}
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
    def apply(self, params: Params, tokens: torch.Tensor, *, prefix_len: int = 0,
              extra_embeddings: Optional[torch.Tensor] = None, remat: str = "full"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) → (logits (B, S, V) f32, aux_loss); with
        ``extra_embeddings`` (B, P, D) prepended (the VLM's patch stubs, cast
        to the model's dtype), logits (B, P + S, V) and ``prefix_len`` at
        least P.

        ``remat="full"`` recomputes each stacked unit in the backward
        (``torch.utils.checkpoint``, non-reentrant), as the JAX package wraps
        each scanned unit in ``jax.remat``; ``"dots"`` recomputes it but
        keeps the outputs of its products without batch dimensions
        (``dots_policy``), as ``jax.checkpoint_dots_with_no_batch_dims``
        does; ``"none"`` keeps every activation."""
        if remat not in ("full", "dots", "none"):
            raise ValueError(f"remat={remat!r}: 'full', 'dots' or 'none'")
        cfg = self.cfg
        params = gathered_table(params)
        # F.embedding: DTensor shards it on a vocab-sharded table (indexing it
        # does not); on the card its backward accumulates a repeated token's
        # rows in float32, indexing's in bf16 (h2o's bf16 grad norms differed
        # by ~1%), so the plain and the mesh step take it alike
        x, prefix_len = _prepend(F.embedding(tokens.long(), params["embed"]), extra_embeddings,
                                 prefix_len)
        x = maybe_shard(x, RESIDUAL)
        unit, n_units, tail = self.scan_groups()
        aux = replicate_like(torch.zeros((), device=x.device), x)

        def run_tail(x, aux):
            for i, kind in enumerate(tail):
                x, a = apply_block_aux(params["tail"][f"t{i}"], x, cfg, kind, mode="train",
                                       prefix_len=prefix_len)
                aux = aux + a
            return x, aux
        if self.tail_first:
            x, aux = run_tail(x, aux)
        for unit_params in _unbind(params["stack"], n_units):
            x, a = rematted(self._unit_apply, remat)(x, unit_params, prefix_len)
            aux = aux + a
        if not self.tail_first:
            x, aux = run_tail(x, aux)
        x = maybe_shard(rms_norm(x, params["ln_f"], cfg.norm_eps), GATHERED)
        return self._head(params, x), aux

    def _unit_apply(self, x: torch.Tensor, unit_params: Params, prefix_len: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        unit = self.scan_groups()[0]
        aux = replicate_like(torch.zeros((), device=x.device), x)
        for i, kind in enumerate(unit):
            x, a = apply_block_aux(unit_params[f"u{i}"], x, self.cfg, kind, mode="train",
                                   prefix_len=prefix_len)
            aux = aux + a
        return x, aux

    # -- loss ----------------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *, remat: str = "full"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token NLL over the ``mask``ed label positions (all when
        no ``mask``) plus the aux loss: ``(loss, {"nll", "aux"})``. The
        batch's ``extra_embeddings`` (the VLM's patches), where it has them,
        are prepended; their rows carry no loss."""
        logits, aux = self.apply(params, batch["tokens"], remat=remat,
                                 extra_embeddings=batch.get("extra_embeddings"))
        nll = self._nll(logits, batch)
        return nll + aux, {"nll": nll, "aux": aux}

    def loss_from_hidden(self, params: Params, x: torch.Tensor,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The mean NLL from the layer stack's output ``x`` (B, S, D) on, as
        ``loss`` takes it from there (final norm, head, NLL): the loss of a
        pipeline executor's output."""
        x = maybe_shard(rms_norm(x, params["ln_f"], self.cfg.norm_eps), GATHERED)
        return self._nll(self._head(params, x), batch)

    def _nll(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        labels = batch["labels"].long()
        if logits.shape[1] != labels.shape[1]:      # prefix rows carry no loss
            logits = logits[:, -labels.shape[1]:]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        return torch.sum(token_nll(logits, labels, mask)) / torch.clamp(torch.sum(mask), min=1.0)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return head(self.cfg, params, x)

    # -- prefill / decode -------------------------------------------------------------
    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params, *,
                extra_embeddings: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
        """The last position's logits (B, 1, V); ``extra_embeddings`` (B, P,
        D) are prepended, so the cache holds P + S positions and decode
        continues at position P + S."""
        return self._serve(params, tokens, cache, mode="prefill", pos=None,
                           extra_embeddings=extra_embeddings)

    def decode(self, params: Params, token: torch.Tensor, cache: Params,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """token (B, 1); pos (B,) — uniform position of the new token."""
        return self._serve(params, token, cache, mode="decode", pos=pos)

    def _serve(self, params: Params, tokens: torch.Tensor, cache: Params, *,
               mode: str, pos: Optional[torch.Tensor],
               extra_embeddings: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        # serving starts from the config's prefix (``apply`` from none), as
        # the JAX package does; under a mesh (params, caches laid out by
        # ``cache_specs``, tokens, ``pos`` and stubs by ``batch_specs``) the
        # stream is laid out as ``apply`` lays it out
        params = gathered_table(params)
        tokens = maybe_shard(tokens, P(BATCH, None))      # a greedy token as the prompt
        x, prefix_len = _prepend(F.embedding(tokens.long(), params["embed"]), extra_embeddings,
                                 cfg.prefix_len)
        x = maybe_shard(x, RESIDUAL)
        for kind, p, c in self._layers(params, cache):
            x = apply_block(p, x, cfg, kind, mode=mode, cache=c, pos=pos, prefix_len=prefix_len)
        x = maybe_shard(rms_norm(x, params["ln_f"], cfg.norm_eps), GATHERED)
        return self._head(params, x[:, -1:]), cache
