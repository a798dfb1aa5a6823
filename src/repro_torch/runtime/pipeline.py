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

``DoraPipelineExecutor`` runs all stages in one process.
``DistributedPipelineExecutor`` runs the same schedule with one process a
stage (rank r is stage r of a ``torch.distributed`` group, see ``ranks``):
activations and their gradients go to the neighbouring ranks by
point-to-point ``send``/``recv``, and since those carry no autograd it runs
its own backward schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
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


def stage_block(stacked: Any, spec: PipelineSpec, s: int) -> Any:
    """Stage ``s``'s (pad, ...) block of the (L, ...) stacked params,
    zero-padded: block ``s`` of ``pack_params``, without the other blocks."""
    lo, n = sum(spec.layers_per_stage[:s]), spec.layers_per_stage[s]

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((spec.pad,) + tuple(x.shape[1:]))
        out[:n].copy_(x[lo:lo + n])
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


def _block_grads(block: Any, layers: List[Any]) -> Any:
    """The (pad, ...) gradient of ``block`` from its true layers' leaf
    views (``layers``): their ``.grad`` in the first slots, exact zeros in
    the padded ones."""
    if isinstance(block, dict):
        return {k: _block_grads(v, [lp[k] for lp in layers]) for k, v in block.items()}
    out = torch.zeros_like(block)
    for i, leaf in enumerate(layers):
        if leaf.grad is not None:
            out[i].copy_(leaf.grad)
    return out


class DistributedPipelineExecutor:
    """GPipe executor with one rank a stage over ``torch.distributed``.

    Built on every rank of the default process group, whose size must be
    the plan's stage count. Rank r runs stage r on the device of its block
    of parameters (``stage_block(stacked, spec, r)``: (pad, ...) leaves,
    padded slots skipped as in ``DoraPipelineExecutor``). Microbatches
    follow the JAX executor's GPipe schedule: rank s takes microbatch m from
    rank s - 1, runs its layers and hands the output to rank s + 1, so it
    runs microbatch t - s at tick t of M + S - 1.

    The hand-off: on an ``nccl`` group the device tensors themselves (one
    rank a card). gloo carries host memory only, so on a ``gloo`` group
    CUDA tensors are copied to a pinned host buffer before ``send`` and
    back to the device after ``recv``; compute stays on the rank's device.
    """

    def __init__(self, plan: ParallelismPlan, n_layers: int,
                 layer_fn: Callable[[Any, torch.Tensor], torch.Tensor]):
        self.spec = PipelineSpec.from_plan(plan, n_layers)
        self.layer_fn = layer_fn
        world = dist.get_world_size()
        if world != self.spec.n_stages:
            raise ValueError(f"plan has {self.spec.n_stages} stages but the process group "
                             f"has {world} ranks")
        self.rank = dist.get_rank()
        self._nccl = dist.get_backend() == "nccl"

    # -- hand-off ----------------------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and not self._nccl

    def _pinned(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _send(self, t: torch.Tensor, dst: int) -> None:
        if self._staged(t):
            t = self._pinned(t).copy_(t)
        dist.send(t.contiguous(), dst)

    def _recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        buf = self._pinned(like) if self._staged(like) else torch.empty_like(like)
        dist.recv(buf, src)
        return buf.to(like.device)

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` as on rank ``src``, on every rank (``t`` gives the shape and
        dtype elsewhere); sent as bytes, so any dtype goes."""
        staged = self._staged(t)
        buf = self._pinned(t) if staged else t.contiguous()
        if staged and self.rank == src:
            buf.copy_(t)
        dist.broadcast(buf.view(-1).view(torch.uint8), src)
        return buf.to(t.device)

    # -- forward -----------------------------------------------------------------------
    def _stage_fn(self, x: torch.Tensor, layers: List[Any],
                  kept: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """One stage call; ``kept`` collects each layer's input."""
        for lp in layers:
            if kept is not None:
                kept.append(x)
            x = self.layer_fn(lp, x)
        return x

    def _stage_grad(self, kept: List[torch.Tensor], layers: List[Any],
                    g: torch.Tensor) -> torch.Tensor:
        """One backward stage call: from the last layer down, recompute the
        layer on its kept input with grad enabled and backpropagate ``g``
        through it; the layers' leaves accumulate their ``.grad``. Returns
        the gradient of the stage's input."""
        for lp, x in zip(reversed(layers), reversed(kept)):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                y = self.layer_fn(lp, x)
            torch.autograd.backward(y, g)
            g = x.grad
        return g

    def _layers(self, block: Any) -> List[Any]:
        return _unbind(block, self.spec.pad)[:self.spec.layers_per_stage[self.rank]]

    def _forward(self, block: Any, x: torch.Tensor, kept: Optional[list]
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """This rank's M stage calls; returns the outputs (last rank only)
        and an empty microbatch on the rank's device. ``kept`` collects
        each call's layer inputs."""
        spec, r = self.spec, self.rank
        S, M = spec.n_stages, spec.n_microbatches
        if x.shape[0] != M:
            raise ValueError(f"plan has {M} microbatches, input has {x.shape[0]}")
        device = _first_leaf(block).device
        like = torch.empty(x.shape[1:], dtype=x.dtype, device=device)
        layers = self._layers(block)
        outs = []
        for m in range(M):
            x_in = x[m].to(device) if r == 0 else self._recv(like, r - 1)
            if kept is not None:
                kept.append([])
            y = self._stage_fn(x_in, layers, None if kept is None else kept[-1])
            if r == S - 1:
                outs.append(y)
            else:
                self._send(y, r + 1)
        return outs, like

    def forward(self, block: Any, x: torch.Tensor) -> torch.Tensor:
        """x: (M, mb, ...) microbatched input, handed to every rank: rank 0
        reads its values, the others only its shape and dtype. Returns the
        pipeline output (M, mb, ...) on every rank's device, as the JAX
        executor's ``psum`` gives it to every stage. No autograd: gradients
        come from ``loss_and_grads``."""
        with torch.no_grad():
            outs, like = self._forward(block, x, None)
            last = self.rank == self.spec.n_stages - 1
            out = torch.stack(outs) if last else like.new_empty((len(x),) + like.shape)
            return self._broadcast(out, self.spec.n_stages - 1)

    def loss_and_grads(self, block: Any, x: torch.Tensor,
                       loss_fn: Callable[[torch.Tensor], torch.Tensor]
                       ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
        """``loss_fn`` applied once to the whole (M, mb, ...) output and its
        gradients, by GPipe's backward ticks in reverse.

        The forward runs without grad and keeps each layer's input. The
        last rank applies ``loss_fn`` and calls ``backward`` on it: leaves
        that ``loss_fn`` closes over (the head) accumulate their ``.grad``
        there. Then, from microbatch M - 1 down, rank s receives its
        output's gradient from rank s + 1, recomputes its stage with grad
        enabled and backpropagates through it, accumulates its parameters'
        gradients and sends the input's gradient to rank s - 1. The
        recompute goes one layer at a time from the kept layer inputs: the
        same launches and arithmetic as the JAX executor's remat of the
        whole stage, with one layer's activations alive at a time, so that
        the ranks' graphs fit beside each other when they share a card.

        Returns, on every rank: the loss (float64, 0-d, the value of
        ``loss_fn``), the gradient of this rank's (pad, ...) block with
        exact zeros in the padded slots, and on rank 0 the gradient of ``x``
        (None elsewhere)."""
        spec, r = self.spec, self.rank
        S, M = spec.n_stages, spec.n_microbatches
        kept: List[Optional[List[torch.Tensor]]] = []
        with torch.no_grad():
            outs, like = self._forward(block, x, kept)
        layers = [_map(lambda a: a.detach().requires_grad_(a.is_floating_point()), lp)
                  for lp in self._layers(block)]
        loss = torch.zeros((), dtype=torch.float64, device=like.device)
        g_out = None
        if r == S - 1:
            out = torch.stack(outs).requires_grad_(True)
            del outs
            value = loss_fn(out)
            value.backward()
            g_out = out.grad
            loss.copy_(value.detach())
        loss = self._broadcast(loss, S - 1)
        grad_x: List[torch.Tensor] = []
        for m in reversed(range(M)):
            g = g_out[m] if r == S - 1 else self._recv(like, r + 1)
            g_in = self._stage_grad(kept[m], layers, g)
            kept[m] = None
            if r > 0:
                self._send(g_in, r - 1)
            else:
                grad_x.append(g_in)
        return (loss, _block_grads(block, layers),
                torch.stack(grad_x[::-1]) if r == 0 else None)
