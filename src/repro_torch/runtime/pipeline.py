"""Dora-plan-driven pipeline executor (PyTorch counterpart of
``repro.runtime.pipeline``).

A ``ParallelismPlan`` with S pipeline stages runs a stacked layer tree as
S stages, each on its own ``torch.device``; microbatches stream through
them GPipe-style on the JAX package's schedule: M + S - 1 ticks, stage s
runs microbatch t - s at tick t. The hand-off to the next stage is
``.to(devices[s + 1])`` (the JAX ``ppermute``), and the finished outputs
come back on the caller's device (the JAX ``psum`` broadcast). Autograd
flows back through the hand-offs, so ``loss(...).backward()`` trains the
pipeline; while grad is enabled each stage call is rematerialised
(non-reentrant ``torch.utils.checkpoint``, the JAX ``jax.remat`` of the
stage function).

Stage imbalance follows the plan: stage s runs ``layers_per_stage[s]``
layers of a ``(S, pad, ...)`` packed tree. Padded slots are identity and
launch nothing (the JAX executor computes them and discards the result);
their gradients are zero, as the JAX executor's are.

All stages run in one process; an executor across processes over
``torch.distributed`` is not ported yet (ROADMAP: Queue 1 'The executor
across processes').
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.plans import ParallelismPlan


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Executable stage layout derived from a Dora plan."""

    n_stages: int
    layers_per_stage: Tuple[int, ...]     # true layer counts (≤ pad)
    pad: int                              # max layers on any stage
    n_microbatches: int

    @classmethod
    def from_plan(cls, plan: ParallelismPlan, n_layers: int) -> "PipelineSpec":
        total_nodes = sum(len(s.node_ids) for s in plan.stages)
        counts = []
        acc = 0
        for s in plan.stages:
            share = round(n_layers * len(s.node_ids) / total_nodes)
            counts.append(max(1, share))
            acc += counts[-1]
        counts[-1] += n_layers - sum(counts)        # fix rounding drift
        counts[-1] = max(1, counts[-1])
        return cls(n_stages=len(plan.stages), layers_per_stage=tuple(counts),
                   pad=max(counts), n_microbatches=plan.n_microbatches)


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unbind(tree: Any, n: int) -> List[Any]:
    """The ``n`` entries of a tree's leading axis, one ``unbind`` a leaf:
    its backward stacks the entries' gradients once (zeros for entries that
    were not used), where ``n`` selects would each add a full-size zero
    gradient."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def pack_params(stacked: Any, spec: PipelineSpec) -> Any:
    """(L, ...) stacked layer params → (S, pad, ...), zero-padded, on the
    stacked tree's device (the JAX ``_pad_stage_params``)."""
    bounds = np.cumsum((0,) + spec.layers_per_stage)

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((spec.n_stages, spec.pad) + tuple(x.shape[1:]))
        for s in range(spec.n_stages):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            out[s, : hi - lo].copy_(x[lo:hi])
        return out
    with torch.no_grad():
        return _map(fn, stacked)


def unpack_params(packed: Any, spec: PipelineSpec) -> Any:
    """(S, pad, ...) → (L, ...): the inverse of ``pack_params`` (padded
    slots dropped); gradients of packed params unpack the same way."""
    return _map(lambda x: torch.cat([x[s, :n] for s, n in enumerate(spec.layers_per_stage)]),
                packed)


class DoraPipelineExecutor:
    """GPipe executor for one decoder-style layer stack.

    ``layer_fn(layer_params, x) -> x`` is a single layer's forward.
    Parameters arrive stacked (L, ...); ``pack_params`` re-packs them per
    stage. ``devices`` holds one ``torch.device`` per stage, by default
    all on the device of the packed params.
    """

    def __init__(self, plan: ParallelismPlan, n_layers: int,
                 layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 devices: Optional[Sequence[Any]] = None):
        self.spec = PipelineSpec.from_plan(plan, n_layers)
        self.layer_fn = layer_fn
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) != self.spec.n_stages:
                raise ValueError(f"plan has {self.spec.n_stages} stages but "
                                 f"{len(devices)} devices were given")
        self.devices = devices

    # -- parameter packing ------------------------------------------------------
    def pack_params(self, stacked_params: Any) -> Any:
        return pack_params(stacked_params, self.spec)

    def unpack_params(self, stage_params: Any) -> Any:
        return unpack_params(stage_params, self.spec)

    # -- forward -------------------------------------------------------------------
    def _stage_fn(self, x: torch.Tensor, layers: List[Any]) -> torch.Tensor:
        for lp in layers:
            x = self.layer_fn(lp, x)
        return x

    def forward(self, stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        """x: (M, mb, ...) microbatched input (already embedded). Returns
        the pipeline output in the same layout, on x's device."""
        spec = self.spec
        S, M = spec.n_stages, spec.n_microbatches
        if x.shape[0] != M:
            raise ValueError(f"plan has {M} microbatches, input has {x.shape[0]}")
        devices = self.devices or [_first_leaf(stage_params).device] * S
        # stage s's true layers, as views on its device (padded slots dropped)
        stages = [[_map(lambda a, d=devices[s]: a.to(d), lp)
                   for lp in _unbind(sp, spec.pad)[:spec.layers_per_stage[s]]]
                  for s, sp in enumerate(_unbind(stage_params, S))]
        remat = torch.is_grad_enabled()
        xs = x.unbind(0)
        buf: List[Optional[torch.Tensor]] = [None] * S    # stage s's next input
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            nxt: List[Optional[torch.Tensor]] = [None] * S
            for s in range(max(0, t - M + 1), min(S, t + 1)):   # stage s runs mb t - s
                x_in = xs[t].to(devices[0]) if s == 0 else buf[s]
                if remat:
                    y = checkpoint(self._stage_fn, x_in, stages[s], use_reentrant=False)
                else:
                    y = self._stage_fn(x_in, stages[s])
                if s == S - 1:
                    outs[t - s] = y.to(x.device)
                else:
                    nxt[s + 1] = y.to(devices[s + 1])
            buf = nxt
        return torch.stack(outs)

    def loss(self, stage_params: Any, x: torch.Tensor,
             loss_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``loss_fn`` applied once to the whole (M, mb, ...) output."""
        return loss_fn(self.forward(stage_params, x))
