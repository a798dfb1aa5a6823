# A copy of src/repro/core/plans.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Hybrid-parallelism plan datatypes (§4.1's ``G_P``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .planning_graph import ModelGraph


@dataclasses.dataclass
class Stage:
    """One pipeline stage: a model subgraph on a data-parallel device group.

    ``microbatch_split[d]`` is the fraction of every microbatch device
    ``d`` processes (§4.1's load-balance rule; fractions sum to 1).
    """

    node_ids: List[int]
    devices: List[int]
    microbatch_split: Dict[int, float]
    tp_degree: int = 1

    # filled by the cost model
    fwd_time: float = 0.0            # per-microbatch forward time (incl. send)
    bwd_time: float = 0.0            # per-microbatch backward time (incl. send)
    comm_bytes_out: float = 0.0      # activation bytes sent downstream per microbatch
    sync_bytes: float = 0.0          # gradient all-reduce bytes per device
    param_bytes: float = 0.0
    flops_fwd: float = 0.0           # per microbatch
    flops_bwd: float = 0.0
    # per-sample recurrent/KV state bytes; None on hand-built stages
    # (the cost model then re-derives it from the graph)
    state_bytes: Optional[float] = None

    @property
    def dp_degree(self) -> int:
        return len(self.devices)


@dataclasses.dataclass
class ParallelismPlan:
    """A complete plan: ordered pipeline stages + microbatching."""

    stages: List[Stage]
    microbatch_size: int
    n_microbatches: int
    training: bool = True

    # evaluated metrics (cost model / scheduler / simulator fill these)
    latency: float = 0.0                 # end-to-end iteration (or token) latency, sec
    energy: float = 0.0                  # total J per iteration across devices
    per_device_energy: Dict[int, float] = dataclasses.field(default_factory=dict)
    per_device_memory: Dict[int, float] = dataclasses.field(default_factory=dict)
    objective: float = 0.0               # Eq. (2) value
    schedule: Optional[object] = None    # Phase-2 refined schedule (core.scheduler)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def devices(self) -> List[int]:
        out: List[int] = []
        for s in self.stages:
            out.extend(s.devices)
        return out

    def device_param_bytes(self) -> Dict[int, float]:
        """Parameter bytes resident per device (for delta-switching §4.3)."""
        out: Dict[int, float] = {}
        for s in self.stages:
            per_dev = s.param_bytes / max(s.tp_degree, 1)
            for d in s.devices:
                out[d] = out.get(d, 0.0) + per_dev
        return out

    def device_layers(self) -> Dict[int, frozenset]:
        """Which planning-graph nodes each device hosts (delta switching)."""
        out: Dict[int, frozenset] = {}
        for s in self.stages:
            ids = frozenset(s.node_ids)
            for d in s.devices:
                out[d] = out.get(d, frozenset()) | ids
        return out

    def summary(self) -> str:
        parts = []
        for i, s in enumerate(self.stages):
            parts.append(
                f"stage{i}[nodes={len(s.node_ids)} devs={s.devices} dp={s.dp_degree} tp={s.tp_degree}]")
        return (f"Plan(mb={self.microbatch_size}x{self.n_microbatches}, "
                f"lat={self.latency * 1e3:.1f}ms, E={self.energy:.2f}J, "
                f"obj={self.objective:.2f}): " + " -> ".join(parts))
