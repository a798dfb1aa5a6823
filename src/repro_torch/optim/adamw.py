"""AdamW with global-norm clipping over the port's nested-dict parameter
trees (PyTorch counterpart of ``repro.optim.adamw``).

Moments and the step count are float32 / int32, as in the JAX package. The
arithmetic follows it step for step: the clip scale from the global norm,
bias corrections from the count, weight decay only on leaves with
``ndim >= 2`` (stacked per-layer vectors included, as there), and the new
parameter computed in float32 and cast back to the leaf's type. Unlike the
JAX package, ``adamw_update`` writes the new parameters and moments into
the given tensors in place (under ``torch.no_grad()``), so a step holds one
copy of the optimizer state in device memory; it returns the same trees.
The norm, the clip scale and the count stay 0-d tensors on the parameters'
device: a step never waits on the host.

Under a device mesh the parameters, gradients and moments are DTensors
(the moments laid out like their parameters; the count a plain tensor).
The global norm sums each leaf's squares as DTensor reduces it and gathers
the total once; the update is elementwise, so it runs on each rank's local
slices in place, after a gradient laid out otherwise than its parameter is
redistributed to the parameter's placements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple, Union

import torch

from ..models.sharding_utils import is_dtensor

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts (``rest`` laid out alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def adamw_init(params: Tree) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    total = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    if is_dtensor(total):
        total = total.full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree,
                 lr: Union[float, torch.Tensor], cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new parameters into ``params`` and the new
    moments into ``state["m"]`` / ``state["v"]`` in place; returns
    ``(params, state, {"grad_norm", "clip_scale"})`` with ``state["count"]``
    a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"]
    if is_dtensor(count):          # replicated (a state restored onto a mesh)
        count = count.to_local()
    count = count + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.float())
    c2 = 1.0 - torch.pow(cfg.b2, count.float())

    def upd(g, m, v, p):
        if is_dtensor(p):
            if g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            g, m, v, p = (t.to_local() for t in (g, m, v, p))
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32 * g32)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        p.copy_((p.float() * (1.0 - lr * decay) - lr * step).to(p.dtype))

    tree_map(upd, grads, state["m"], state["v"], params)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "clip_scale": scale}
