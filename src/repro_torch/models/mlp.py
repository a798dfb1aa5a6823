"""MLP blocks: dense (gated / standard) and Mixture-of-Experts (PyTorch
counterpart of ``repro.models.mlp``).

MoE uses token-choice top-k routing with static expert capacity and
sort-based dispatch, operation for operation as the JAX package computes
it: the capacity semantics (which token an expert drops) are the function.
Dropped tokens fall into one trash row of the dispatch buffer, the
counterpart of JAX's scatter ``mode='drop'``; the combine path gathers and
weight-sums the k expert outputs per token in slot order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .common import activation, dense_init
from .config import ArchConfig
from .sharding_utils import BATCH, P, maybe_shard


# -- dense MLP -----------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, dtype,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
         "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, lead=lead)
    return p


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    fn = activation(act)
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = fn(x @ p["w_gate"]) * h
    else:
        h = fn(h)
    return h @ p["w_down"]


# -- MoE -------------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype,
             lead: Tuple[int, ...] = ()) -> Dict:
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, lead=lead),
        "w_up": dense_init(gen, (e, d, f), dtype, lead=lead),
        "w_gate": dense_init(gen, (e, d, f), dtype, lead=lead),
        "w_down": dense_init(gen, (e, f, d), dtype, fan_in=f, lead=lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared_experts, cfg.gated_mlp, dtype, lead)
    return p


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
              / cfg.n_experts) + 1
    return max(cap, cfg.experts_per_token)


def dispatch_groups(n_tokens: int, cfg: ArchConfig) -> int:
    """Dispatch-group count G: tokens are routed within G independent
    groups, so the sorts and scatters of token-choice routing stay local to
    a batch shard under a mesh. 32 = the widest batch-shard count of the
    production meshes."""
    if cfg.moe_groups:
        return cfg.moe_groups
    for g in (32, 16, 8, 4, 2):
        if n_tokens % g == 0 and n_tokens // g >= cfg.experts_per_token:
            return g
    return 1


class Routing(NamedTuple):
    """One MoE layer's routing of (G, Tl) tokens: the top-k experts and their
    renormalised gates (G, Tl, K, f32), each (token, slot)'s row in the
    (G, E·C) dispatch buffer (G, Tl, K), ``E·C`` where the slot was dropped,
    the capacity C and the Switch aux loss."""
    experts: torch.Tensor
    gate: torch.Tensor
    dest: torch.Tensor
    capacity: int
    aux: torch.Tensor


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, ties broken by the
    lower index (a stable descending sort keeps equal values in index order;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Dict, xg: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Token-choice top-k routing with capacity of ``xg`` (G, Tl, D)."""
    G, Tl, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(cfg, Tl)
    logits = torch.einsum("gtd,de->gte", xg, p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = _top_k(probs, K)                                   # (G, Tl, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)  # renorm

    # Switch-style load-balance auxiliary loss (global means)
    me = torch.mean(probs, dim=(0, 1))                              # (E,)
    ce = torch.mean(torch.nn.functional.one_hot(eidx[..., 0], E).float(), dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # ---- per-group sort-based ranking (1-D arrays only) ---------------------
    flat_e = eidx.reshape(G, Tl * K)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)       # (G, Tl·K)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=xg.device).expand(G, E).contiguous())   # (G, E)
    rank = torch.arange(Tl * K, device=xg.device)[None] - torch.gather(starts, -1, sorted_e)
    dest_sorted = torch.where(rank < C, sorted_e * C + rank, E * C)  # E*C = drop
    inv = torch.argsort(order, dim=-1)                              # the inverse permutation
    dest = torch.gather(dest_sorted, -1, inv).reshape(G, Tl, K)     # per (t, k)
    return Routing(eidx, gate, dest, C, aux)


def apply_moe(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux_loss). Token-choice top-k with capacity.

    Grouped local dispatch: routing and the sort/rank arithmetic run per
    dispatch group; tokens are scattered one routing slot k at a time, so
    nothing of shape (T·K, D) is ever materialised. The scatter writes into
    E·C + 1 rows, the last one the trash row of every dropped slot (the only
    row that receives duplicate indices, so the scatter's order there does
    not matter), and the expert products run on the first E·C."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = dispatch_groups(T, cfg)
    Tl = T // G
    fn = activation(cfg.act)

    xg = x.reshape(G, Tl, D)
    xg = maybe_shard(xg, P(BATCH, None, None))
    r = route(p, xg, cfg)
    C, EC = r.capacity, E * r.capacity

    # ---- dispatch: one scatter of (G, Tl, D) per routing slot ----------------
    buf = maybe_shard(torch.zeros((G, EC + 1, D), dtype=x.dtype, device=x.device),
                      P(BATCH, None, "model"))
    xg_d = maybe_shard(xg, P(BATCH, None, "model"))
    for k in range(K):
        buf.scatter_(1, r.dest[:, :, k, None].expand(G, Tl, D), xg_d)
    h = buf[:, :EC].reshape(G, E, C, D)
    h = maybe_shard(h, P(BATCH, "model", None, None))
    up = torch.einsum("gecd,edf->gecf", h, p["w_up"])
    gt = torch.einsum("gecd,edf->gecf", h, p["w_gate"])
    y = torch.einsum("gecf,efd->gecd", fn(gt) * up, p["w_down"])
    y = maybe_shard(y, P(BATCH, "model", None, None))
    yf = maybe_shard(y.reshape(G, EC, D), P(BATCH, None, "model"))

    # ---- combine: one gather of (G, Tl, D) per routing slot ------------------
    out = torch.zeros((G, Tl, D), dtype=x.dtype, device=x.device)
    for k in range(K):
        dk = r.dest[:, :, k]
        live = dk < EC
        safe = torch.where(live, dk, 0)
        vals = torch.gather(yf, 1, safe[..., None].expand(G, Tl, D))     # (G, Tl, D)
        w = (r.gate[:, :, k] * live).to(x.dtype)[..., None]
        out = out + vals * w

    if "shared" in p:
        out = out + apply_mlp(p["shared"], xg.reshape(T, D), cfg.act).reshape(G, Tl, D)
    return out.reshape(B, S, D), r.aux
