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

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .common import activation, dense_init
from .config import ArchConfig
from .sharding_utils import BATCH, P, is_dtensor, maybe_shard, moved, on_shards, summed_where


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


def _route_local(xg: torch.Tensor, router: torch.Tensor, cfg: ArchConfig, C: int
                 ) -> Tuple[torch.Tensor, ...]:
    """The routing of ``xg`` (G, Tl, D) on one rank's groups: the top-k
    experts, their gates, each slot's row, and the mean router probability
    and top-1 share of each expert over these groups, (1, E) each."""
    G, Tl, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = torch.einsum("gtd,de->gte", xg, router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = _top_k(probs, K)                                   # (G, Tl, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)  # renorm
    me = torch.mean(probs, dim=(0, 1))[None]                        # (1, E)
    ce = torch.mean(torch.nn.functional.one_hot(eidx[..., 0], E).float(), dim=(0, 1))[None]

    # ---- per-group sort-based ranking (1-D arrays only) ---------------------
    flat_e = eidx.reshape(G, Tl * K)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)       # (G, Tl·K)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=xg.device).expand(G, E).contiguous())   # (G, E)
    rank = torch.arange(Tl * K, device=xg.device)[None] - torch.gather(starts, -1, sorted_e)
    dest_sorted = torch.where(rank < C, sorted_e * C + rank, E * C)  # E*C = drop
    inv = torch.argsort(order, dim=-1)                              # the inverse permutation
    dest = torch.gather(dest_sorted, -1, inv).reshape(G, Tl, K)     # per (t, k)
    return eidx, gate, dest, me, ce


def route(p: Dict, xg: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Token-choice top-k routing with capacity of ``xg`` (G, Tl, D).

    Under a mesh ``xg`` is laid out with its groups over the batch axes and
    replicated over "model"; each rank routes its own groups with the whole
    router (gathered; its gradient summed over the batch axes), and the
    Switch aux loss takes the global means over (G, Tl) as the means of the
    ranks' means (equal group counts)."""
    G, Tl, _ = xg.shape
    C = moe_capacity(cfg, Tl)
    fn = functools.partial(_route_local, cfg=cfg, C=C)
    if is_dtensor(xg):
        pl = tuple(xg.placements)                 # the groups over the batch axes, or whole
        rep = moved(pl, {0: None})
        eidx, gate, dest, me, ce = on_shards(
            fn, (xg, p["router"]), ins=(pl, rep), grads=(None, summed_where(rep, pl, (0,))),
            outs=(pl,) * 5)
    else:
        eidx, gate, dest, me, ce = fn(xg, p["router"])
    # Switch-style load-balance auxiliary loss (global means)
    aux = cfg.router_aux_coef * cfg.n_experts * torch.sum(me.mean(0) * ce.mean(0))
    return Routing(eidx, gate, dest, C, aux)


def _dispatch(dest: torch.Tensor, xg: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """(G, E, C, D) expert inputs: one scatter of (G, Tl, D) per routing slot
    into E·C + 1 rows, the last the trash row of every dropped slot (the only
    row that receives duplicate indices, so the scatter's order there does
    not matter)."""
    G, Tl, D = xg.shape
    buf = torch.zeros((G, E * C + 1, D), dtype=xg.dtype, device=xg.device)
    for k in range(dest.shape[-1]):
        buf.scatter_(1, dest[:, :, k, None].expand(G, Tl, D), xg)
    return buf[:, :E * C].reshape(G, E, C, D)


def _experts(h: torch.Tensor, w_up: torch.Tensor, w_gate: torch.Tensor, w_down: torch.Tensor,
             act: str) -> torch.Tensor:
    """The gated expert MLPs of (G, E, C, D) inputs."""
    up = torch.einsum("gecd,edf->gecf", h, w_up)
    gt = torch.einsum("gecd,edf->gecf", h, w_gate)
    return torch.einsum("gecf,efd->gecd", activation(act)(gt) * up, w_down)


def _combine(y: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(G, Tl, D): one gather of (G, Tl, D) per routing slot from the expert
    outputs y (G, E, C, D), weighted by the slot's gate (0 where dropped)."""
    G, E, C, D = y.shape
    EC = E * C
    yf = y.reshape(G, EC, D)
    Tl = dest.shape[1]
    out = torch.zeros((G, Tl, D), dtype=y.dtype, device=y.device)
    for k in range(dest.shape[-1]):
        dk = dest[:, :, k]
        live = dk < EC
        safe = torch.where(live, dk, 0)
        vals = torch.gather(yf, 1, safe[..., None].expand(G, Tl, D))     # (G, Tl, D)
        w = (gate[:, :, k] * live).to(y.dtype)[..., None]
        out = out + vals * w
    return out


class _Uses(torch.autograd.Function):
    """``n`` uses of one tensor whose gradients are summed in the uses' order,
    whatever order autograd's engine finishes them in: under a mesh the
    ``local_map`` boundaries reorder the engine's work, and three bf16
    gradients summed in another order round differently."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g if total is None else total + g
        return total, None


def apply_moe(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux_loss). Token-choice top-k with capacity.

    Grouped local dispatch: routing and the sort/rank arithmetic run per
    dispatch group; tokens are scattered one routing slot k at a time, so
    nothing of shape (T·K, D) is ever materialised, and the expert products
    run on the E·C rows.

    Under a mesh, as the reference lays it out: the groups over the batch
    axes; the routing, the dispatch scatters and the combine gathers local
    to each rank's groups (``on_shards``), the dispatch buffer and the
    combine's inputs D-sharded over "model"; one reshard of the buffer to
    experts over "model" (the expert-parallel all-to-all) for the three
    expert products, which each rank runs on its own experts, its weights
    gathered over the batch axes only; and one back."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    G = dispatch_groups(T, cfg)
    Tl = T // G

    xg = maybe_shard(x.reshape(G, Tl, D), P(BATCH, None, None))
    uses = 3 if "shared" in p else 2
    xg_r, xg_d, *xg_s = _Uses.apply(xg, uses) if xg.requires_grad else (xg,) * uses
    r = route(p, xg_r, cfg)
    C = r.capacity
    xg_d = maybe_shard(xg_d, P(BATCH, None, "model"))
    if is_dtensor(xg_d):
        pl_r, pl_d = tuple(r.dest.placements), tuple(xg_d.placements)
        h = on_shards(functools.partial(_dispatch, E=E, C=C), (r.dest, xg_d),
                      ins=(pl_r, pl_d), outs=moved(pl_d, {2: 3}))
        h = maybe_shard(h, P(BATCH, "model", None, None))
        pl_h = tuple(h.placements)
        pl_w = moved(pl_h, {0: None, 1: 0})       # own experts, whole over the batch axes
        w_grad = summed_where(pl_w, pl_h, (0,))
        y = on_shards(functools.partial(_experts, act=cfg.act),
                      (h, p["w_up"], p["w_gate"], p["w_down"]), ins=(pl_h, pl_w, pl_w, pl_w),
                      grads=(None, w_grad, w_grad, w_grad), outs=pl_h)
        y = maybe_shard(y, P(BATCH, None, None, "model"))
        pl_y = tuple(y.placements)
        out = on_shards(_combine, (y, r.dest, r.gate), ins=(pl_y, pl_r, pl_r),
                        grads=(None, None, summed_where(pl_r, pl_y, (3,))),
                        outs=moved(pl_y, {3: 2}))
    else:
        out = _combine(_experts(_dispatch(r.dest, xg_d, E, C), p["w_up"], p["w_gate"],
                                p["w_down"], cfg.act), r.dest, r.gate)

    if "shared" in p:
        out = out + apply_mlp(p["shared"], xg_s[0].reshape(T, D), cfg.act).reshape(G, Tl, D)
    return out.reshape(B, S, D), r.aux
