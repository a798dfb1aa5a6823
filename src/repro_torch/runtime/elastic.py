"""Elastic training controller: node loss → regroup the surviving ranks →
shrink the mesh → restore from checkpoint with resharding → resume
(PyTorch counterpart of ``repro.runtime.elastic``).

The controller composes the substrate pieces: the Coordinator detects
failures, the survivors form a process group of their own, and the
Checkpointer's elastic restore maps saved shards onto the new mesh.

A process group cannot lose members in place, and nothing may touch the old
group once a peer is gone (a collective with a dead peer ends, at best, at
the group's timeout). So ``remesh`` first calls
``runtime.ranks.regroup(survivors, generation)``: each survivor leaves the
old group (if it has not left on the verdict already) and joins a fresh one
of the survivors alone, and a failed rank that still runs just leaves. Every rank is fed the same beats
(``coordinator.beat``/``tick`` on one deterministic clock), so all survivors
reach the same verdict without talking to each other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from ..checkpoint import Checkpointer, latest_step
from ..models.sharding_utils import clean_spec, mesh_sizes, placements
from .heartbeat import Coordinator
from .ranks import regroup


@dataclasses.dataclass
class ElasticState:
    mesh: Any
    step: int
    params: Any
    opt_state: Any
    generation: int = 0          # bumps on every re-mesh


def sharded_targets(tree_shapes: Any, specs: Any, mesh) -> Any:
    """Meta DTensors laid out by ``specs`` on ``mesh``, shaped and typed as
    the leaves of ``tree_shapes``: restore targets that hold no data."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree_shapes, dict):
        return {k: sharded_targets(v, specs[k], mesh) for k, v in tree_shapes.items()}
    meta = torch.empty(tree_shapes.shape, dtype=tree_shapes.dtype, device="meta")
    spec = clean_spec(specs, meta.shape, mesh_sizes(mesh))
    return distribute_tensor(meta, mesh, placements(spec, mesh), src_data_rank=None)


class ElasticController:
    """Owns the train loop's distributed state across mesh generations."""

    def __init__(self, *, make_mesh: Callable[[int], Any],
                 spec_fn: Callable[[Any, Any], Tuple[Any, Any]],
                 ckpt: Checkpointer, n_devices: int):
        """``make_mesh(n)`` builds a mesh over the n ranks of the current
        group; ``spec_fn(mesh, shapes)`` returns the specs of the train state
        for that mesh."""
        self.make_mesh = make_mesh
        self.spec_fn = spec_fn
        self.ckpt = ckpt
        self.n_devices = n_devices
        self.coordinator = Coordinator(list(range(n_devices)),
                                       on_failure=self._on_failure)
        self._pending_failures: List[int] = []

    def _on_failure(self, failed: List[int]) -> None:
        self._pending_failures.extend(failed)

    def needs_remesh(self) -> bool:
        return bool(self._pending_failures)

    def remesh(self, state: ElasticState, train_tree_shapes) -> Optional[ElasticState]:
        """Regroup the healthy ranks, shrink the mesh to them and restore the
        latest committed checkpoint onto it. Returns None on a rank that is
        not among the healthy (it has left the group).

        ``train_tree_shapes`` — the combined {params, opt} tree with shapes
        and dtypes only (``meta`` tensors); layouts are recomputed for the
        shrunk mesh by ``spec_fn``."""
        healthy = self.coordinator.healthy
        if not healthy:
            raise RuntimeError("no healthy devices left")
        generation = state.generation + 1
        if not regroup(healthy, generation):
            return None
        new_mesh = self.make_mesh(len(healthy))
        specs = self.spec_fn(new_mesh, train_tree_shapes)
        step = latest_step(self.ckpt.dir)
        if step is None:
            raise RuntimeError("no checkpoint to restore after failure")
        tree = self.ckpt.restore(step, sharded_targets(train_tree_shapes, specs, new_mesh))
        self._pending_failures.clear()
        return ElasticState(mesh=new_mesh, step=step,
                            params=tree["params"], opt_state=tree["opt"],
                            generation=generation)
