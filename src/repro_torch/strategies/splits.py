# A copy of src/repro/strategies/splits.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Split-centric planner strategies beyond the paper's §6.1 baselines.

* ``throughput_max``   — rate-optimal planning on the *real* topology
  (the cloud-planner objective without Asteroid's idealized-D2D twist):
  heterogeneity-aware, but blind to QoE, energy, pipeline fill/drain and
  contention.
* ``chain_split``      — DistrEdge-style layer chaining (arXiv:2202.01699):
  one device per stage in speed order, boundaries balanced proportional
  to device compute rates; falls back to memory-capacity balancing when
  the speed balance does not fit.
* ``memory_balanced``  — the same chain with boundaries proportional to
  device memory: the safe choice for memory-starved fleets, usually
  compute-imbalanced.
* ``pareto_split``     — "Where to Split?"-style analysis
  (arXiv:2601.08025): enumerate device prefixes × contiguous device
  groupings × balanced layer boundaries × microbatch sizes, price each
  candidate in (latency, energy), keep the Pareto front and pick the
  QoE-objective winner from it.

All four are contention-oblivious planners; their plans are priced under
fluid-fair contention on the real medium before being returned.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..core.adapter import pareto_filter
from ..core.cost_model import CostModel, CostProvider, Workload, resolve_costs
from ..core.device import Topology
from ..core.partitioner import ModelPartitioner, PartitionerConfig
from ..core.planner import PlanningResult
from ..core.planning_graph import ModelGraph
from ..core.plans import ParallelismPlan
from ..core.qoe import QoESpec
from .base import StrategyError, _Stopwatch, as_result, fair_executed, \
    register_strategy
from .baselines import LATENCY_ONLY, _balance_boundaries, _chain_nodes, \
    _contiguous_splits, _make_plan, _mb_sweep, plan_memory_ok


@register_strategy
class ThroughputMaxStrategy:
    """Throughput-only planning on the real topology: bottleneck-stage
    rate is the whole objective (no QoE, no energy, no contention)."""

    name = "throughput_max"
    contention_aware = False

    def __init__(self, top_k: int = 1, delta: float = 0.05):
        self.top_k = top_k
        self.delta = delta

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        topo = resolve_costs(costs).calibrate(topology)
        watch = _Stopwatch()
        cfg = PartitionerConfig(top_k=max(self.top_k, 1), delta=self.delta,
                                microbatch_sizes=_mb_sweep(workload),
                                objective_mode="throughput")
        part = ModelPartitioner(graph, topo, LATENCY_ONLY, cfg)
        cands = part.plan(workload)
        if not cands:
            raise StrategyError("throughput_max found no feasible plan")
        for p in cands:
            p.meta["planner"] = self.name
            p.meta["graph"] = part.graph
        phase1_s = watch.lap()
        executed = [fair_executed(p, topo, qoe) for p in cands]
        return as_result(executed, phase1_s, watch.lap())


def _chain_plan(graph: ModelGraph, topo: Topology, wl: Workload,
                weights: Sequence[float], dev_order: Sequence[int],
                delta: float) -> ParallelismPlan:
    """One chain split: contiguous layer groups balanced ∝ ``weights``,
    one device (in ``dev_order``) per stage."""
    g = graph.compress(delta)
    order = _chain_nodes(g)
    S = min(len(dev_order), len(order))
    devs = list(dev_order)[:S]
    node_costs = [g.nodes[i].flops_fwd + g.nodes[i].flops_bwd for i in order]
    sizes = _balance_boundaries(node_costs, list(weights)[:S])
    groups, i = [], 0
    for sz in sizes:
        groups.append(order[i:i + sz])
        i += sz
    plan = _make_plan(g, topo, wl, LATENCY_ONLY, groups, [[d] for d in devs])
    plan.meta["graph"] = g
    return plan


class _ChainBaseline:
    """Shared chain-split machinery for chain_split / memory_balanced."""

    name = "abstract"
    contention_aware = False
    delta = 0.05

    def _weights(self, topo: Topology, dev_order: Sequence[int]
                 ) -> List[float]:
        raise NotImplementedError

    def _order(self, topo: Topology) -> List[int]:
        raise NotImplementedError

    def _fallback_weights(self, topo: Topology, dev_order: Sequence[int]
                          ) -> Optional[List[float]]:
        """Second-chance weights when the primary balance OOMs (None ->
        no distinct fallback exists, fail straight away)."""
        return None

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        topo = resolve_costs(costs).calibrate(topology)
        watch = _Stopwatch()
        dev_order = self._order(topo)
        plan = _chain_plan(graph, topo, workload,
                           self._weights(topo, dev_order), dev_order,
                           self.delta)
        ok, why = plan_memory_ok(plan, topo)
        if not ok:
            fallback = self._fallback_weights(topo, dev_order)
            if fallback is None:
                raise StrategyError(f"{self.name} plan OOM: {why}")
            plan = _chain_plan(graph, topo, workload, fallback, dev_order,
                               self.delta)
            ok, why = plan_memory_ok(plan, topo)
            if not ok:
                raise StrategyError(f"{self.name} plan OOM: {why}")
        plan.meta["planner"] = self.name
        phase1_s = watch.lap()
        executed = fair_executed(plan, topo, qoe)
        return as_result([executed], phase1_s, watch.lap())


@register_strategy
class ChainSplitStrategy(_ChainBaseline):
    """DistrEdge-style chaining: fast devices first, compute-balanced."""

    name = "chain_split"

    def _order(self, topo: Topology) -> List[int]:
        return sorted(range(topo.n),
                      key=lambda d: topo.devices[d].effective_flops(),
                      reverse=True)

    def _weights(self, topo: Topology, dev_order: Sequence[int]) -> List[float]:
        return [topo.devices[d].effective_flops() for d in dev_order]

    def _fallback_weights(self, topo: Topology, dev_order: Sequence[int]
                          ) -> Optional[List[float]]:
        # speed balance OOMed: retry balanced on memory capacity
        return [topo.devices[d].memory for d in dev_order]


@register_strategy
class MemoryBalancedStrategy(_ChainBaseline):
    """Chain split with layer counts proportional to device memory."""

    name = "memory_balanced"

    def _order(self, topo: Topology) -> List[int]:
        return sorted(range(topo.n),
                      key=lambda d: topo.devices[d].memory, reverse=True)

    def _weights(self, topo: Topology, dev_order: Sequence[int]) -> List[float]:
        return [topo.devices[d].memory for d in dev_order]


@register_strategy
class ParetoSplitStrategy:
    """Split-point Pareto analysis ("Where to Split?").

    Enumerates (device-prefix length × contiguous device groupings ×
    speed-balanced layer boundaries × microbatch sizes) over fast-first
    and slow-first device orderings, prices every candidate analytically
    in (latency, energy), keeps the Pareto front, fair-executes the
    front on the real medium and returns the QoE-objective winner."""

    name = "pareto_split"
    contention_aware = False

    def __init__(self, delta: float = 0.05, max_front: int = 12):
        self.delta = delta
        self.max_front = max_front

    def _candidates(self, graph: ModelGraph, topo: Topology, qoe: QoESpec,
                    wl: Workload) -> List[ParallelismPlan]:
        g = graph.compress(self.delta)
        order = _chain_nodes(g)
        node_costs = [g.nodes[i].flops_fwd + g.nodes[i].flops_bwd
                      for i in order]
        by_speed = sorted(range(topo.n),
                          key=lambda d: topo.devices[d].effective_flops(),
                          reverse=True)
        out: List[ParallelismPlan] = []
        seen = set()
        for mb in _mb_sweep(wl):
            if wl.global_batch % mb:
                continue
            wl_mb = dataclasses.replace(wl, microbatch_size=mb)
            cm = CostModel(g, topo, wl_mb)
            for dev_order in (by_speed, list(reversed(by_speed))):
                for used in range(1, topo.n + 1):
                    prefix = dev_order[:used]
                    for S in range(1, min(used, len(order)) + 1):
                        for dev_sizes in _contiguous_splits(used, S):
                            dgs, i = [], 0
                            for sz in dev_sizes:
                                dgs.append(prefix[i:i + sz])
                                i += sz
                            weights = [sum(topo.devices[d].effective_flops()
                                           for d in dg) for dg in dgs]
                            sizes = _balance_boundaries(node_costs, weights)
                            groups, i = [], 0
                            for sz in sizes:
                                groups.append(order[i:i + sz])
                                i += sz
                            key = (mb, tuple(tuple(dg) for dg in dgs),
                                   tuple(sizes))
                            if key in seen:
                                continue
                            seen.add(key)
                            try:
                                stages = [cm.make_stage(list(nids), list(dg))
                                          for nids, dg in zip(groups, dgs)]
                            except Exception:
                                continue
                            if not all(cm.memory_feasible(st, qoe,
                                                          n_stages_hint=S)
                                       for st in stages):
                                continue
                            plan = cm.evaluate(stages, qoe, "1f1b")
                            plan.meta["planner"] = self.name
                            plan.meta["graph"] = g
                            out.append(plan)
        return out

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        topo = resolve_costs(costs).calibrate(topology)
        watch = _Stopwatch()
        cands = self._candidates(graph, topo, qoe, workload)
        if not cands:
            raise StrategyError("pareto_split found no feasible split")
        front = pareto_filter(cands)[: self.max_front]
        phase1_s = watch.lap()
        executed = [fair_executed(p, topo, qoe) for p in front]
        return as_result(executed, phase1_s, watch.lap())
