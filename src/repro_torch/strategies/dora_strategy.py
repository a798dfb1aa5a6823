# A copy of src/repro/strategies/dora_strategy.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""The ``dora`` strategy — Algorithm 1 behind the registry protocol.

A thin, transformation-free wrapper over :class:`core.planner.DoraPlanner`:
given the same configuration, ``get_strategy("dora").plan(...)`` returns
exactly what calling ``DoraPlanner`` directly returns (tests assert the
plans are byte-identical).  Convenience knobs ``top_k``/
``sweep_microbatch`` build the richer search configuration the
benchmark harnesses use (``sim.runner.dora_plan``).
"""
from __future__ import annotations

from typing import Optional

from ..core.adapter import AdapterConfig
from ..core.cost_model import CostProvider, Workload
from ..core.device import Topology
from ..core.partitioner import PartitionerConfig
from ..core.planner import DoraPlanner, PlanningResult
from ..core.planning_graph import ModelGraph
from ..core.qoe import QoESpec
from ..core.scheduler import SchedulerConfig
from .base import register_strategy
from .baselines import _mb_sweep


@register_strategy
class DoraStrategy:
    """QoE-aware three-phase planning (partition → schedule → Pareto)."""

    name = "dora"
    contention_aware = True

    def __init__(self,
                 partitioner_config: Optional[PartitionerConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 adapter_config: Optional[AdapterConfig] = None,
                 top_k: Optional[int] = None,
                 sweep_microbatch: bool = False):
        if partitioner_config is not None and (top_k or sweep_microbatch):
            raise ValueError("pass either partitioner_config or the "
                             "top_k/sweep_microbatch shorthands, not both")
        self.partitioner_config = partitioner_config
        self.scheduler_config = scheduler_config
        self.adapter_config = adapter_config
        self.top_k = top_k
        self.sweep_microbatch = sweep_microbatch

    def _partitioner_config(self, wl: Workload) -> Optional[PartitionerConfig]:
        if self.partitioner_config is not None:
            return self.partitioner_config
        if self.top_k is None and not self.sweep_microbatch:
            return None                      # DoraPlanner defaults
        return PartitionerConfig(
            top_k=self.top_k or 10,
            microbatch_sizes=_mb_sweep(wl) if self.sweep_microbatch else ())

    def planner(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
                workload: Workload,
                costs: Optional[CostProvider] = None) -> DoraPlanner:
        """The configured raw planner (for callers that also want the
        adapter, e.g. ``dora.serve``)."""
        return DoraPlanner(graph, topology, qoe,
                           partitioner_config=self._partitioner_config(workload),
                           scheduler_config=self.scheduler_config,
                           adapter_config=self.adapter_config,
                           costs=costs)

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        return self.planner(graph, topology, qoe, workload,
                            costs=costs).plan(workload)
