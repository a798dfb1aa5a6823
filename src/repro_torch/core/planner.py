# A copy of src/repro/core/planner.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Algorithm 1 — QoE-aware hybrid parallelism planner (end-to-end)."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

from .adapter import AdapterConfig, RuntimeAdapter, pareto_filter
from .cost_model import CostModel, CostProvider, Workload, resolve_costs
from .device import Topology
from .partitioner import ModelPartitioner, PartitionerConfig
from .planning_graph import ModelGraph
from .plans import ParallelismPlan
from .qoe import QoESpec
from .scheduler import NetworkScheduler, SchedulerConfig


@dataclasses.dataclass
class PlanningResult:
    best: ParallelismPlan
    candidates: List[ParallelismPlan]       # Phase-2 refined, ranked
    pareto: List[ParallelismPlan]           # for the runtime adapter
    phase1_s: float
    phase2_s: float
    #: True when this result came from `DoraPlanner.replan`'s warm path
    #: (re-priced previous pool, no fresh DP search)
    warm_start: bool = False

    @property
    def total_s(self) -> float:
        return self.phase1_s + self.phase2_s


class DoraPlanner:
    """ParallelismPlanner(G_M, D) per Algorithm 1."""

    def __init__(self, graph: ModelGraph, topo: Topology, qoe: QoESpec,
                 partitioner_config: Optional[PartitionerConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 adapter_config: Optional[AdapterConfig] = None,
                 costs: Optional[CostProvider] = None):
        self.graph = graph
        self.costs = resolve_costs(costs)
        # the whole stack (partitioner, scheduler, adapter) plans against
        # the provider's view of the hardware — analytic by default,
        # measurement-calibrated with ProfiledCosts
        self.topo = self.costs.calibrate(topo)
        self.qoe = qoe
        self.partitioner = ModelPartitioner(self.graph, self.topo, qoe,
                                            partitioner_config)
        self.scheduler = NetworkScheduler(self.topo, qoe, scheduler_config)
        self.adapter_config = adapter_config

    def plan(self, workload: Workload) -> PlanningResult:
        t0 = time.perf_counter()
        pool = self.partitioner.plan(workload, pool=True)  # lines 2-3 (top-K pool)
        t1 = time.perf_counter()
        refined = self.scheduler.refine_candidates(        # line 4
            pool, keep=self.partitioner.config.top_k)
        t2 = time.perf_counter()
        if not refined:
            raise RuntimeError("no QoE-feasible plan found")
        return PlanningResult(best=refined[0], candidates=refined,
                              pareto=pareto_filter(refined),
                              phase1_s=t1 - t0, phase2_s=t2 - t1)

    def make_adapter(self, result: PlanningResult) -> RuntimeAdapter:
        return RuntimeAdapter(result.candidates, self.topo, self.qoe,
                              self.scheduler, self.adapter_config)

    # -- warm-start replanning (§4.3 fast path) -----------------------------------
    def replan(self, workload: Workload,
               prev: Union[PlanningResult, Sequence[ParallelismPlan]],
               mapping: Optional[Dict[int, int]] = None,
               keep: Optional[int] = None) -> PlanningResult:
        """Warm-start replanning: re-price a previous result's
        candidate/Pareto pool on *this* planner's topology and re-refine
        only the head under real contention, falling back to the full
        fresh DP (:meth:`plan`) only when no re-priced candidate is
        QoE-feasible.

        ``prev`` — the previous :class:`PlanningResult` (or a plain plan
        sequence).  ``mapping`` translates the previous plans' device
        ids into this planner's topology (``None`` = identity); device
        ids missing from the mapping have left the fleet — their stages
        are rebuilt on the stage's surviving devices, and plans with a
        fully-departed or memory-infeasible stage drop out of the warm
        pool.  ``keep`` bounds the Phase-2 chunk-search head (defaults
        to the partitioner's ``top_k``); each kept plan is re-refined
        with its previously winning chunk count, so a steady-state churn
        replan prices ~pool-size schedules instead of re-running the
        whole DP × chunk-mode search.
        """
        t0 = time.perf_counter()
        if isinstance(prev, PlanningResult):
            pool: List[ParallelismPlan] = list(prev.candidates)
            for p in prev.pareto:
                if p not in pool:
                    pool.append(p)
        else:
            pool = list(prev)
        warm: List[ParallelismPlan] = []
        seen = set()
        for p in pool:
            q = self._warm_reprice(p, mapping, workload)
            if q is None:
                continue
            sig = tuple((tuple(s.node_ids), tuple(s.devices))
                        for s in q.stages) + (q.microbatch_size,)
            if sig in seen:
                continue
            seen.add(sig)
            warm.append(q)
        warm.sort(key=self.partitioner._rank_key)
        t1 = time.perf_counter()
        if warm:
            keep = keep if keep is not None else self.partitioner.config.top_k
            def refine_fast(p: ParallelismPlan) -> ParallelismPlan:
                w_prev = p.meta.get("chunks")
                modes = ((w_prev,) if w_prev else ()) \
                    if isinstance(w_prev, int) else None
                return self.scheduler.refine(p, modes=modes)

            ranked = [refine_fast(p) for p in warm[:keep]] + warm[keep:]
            ranked.sort(key=lambda p: p.objective)
            # the served winner must be contention-priced: a tail plan
            # still carrying its optimistic contention-free estimate may
            # outrank the refined head, so refine ranked[0] until a
            # refined plan genuinely tops the ranking (usually 0 extra
            # refines; bounded by the pool size)
            while ranked[0].schedule is None:
                ranked[0] = refine_fast(ranked[0])
                ranked.sort(key=lambda p: p.objective)
            t2 = time.perf_counter()
            if self.qoe.satisfied(ranked[0]):
                return PlanningResult(best=ranked[0], candidates=ranked,
                                      pareto=pareto_filter(ranked),
                                      phase1_s=t1 - t0, phase2_s=t2 - t1,
                                      warm_start=True)
        return self.plan(workload)

    def _warm_reprice(self, plan: ParallelismPlan,
                      mapping: Optional[Dict[int, int]],
                      workload: Workload) -> Optional[ParallelismPlan]:
        """One previous candidate re-priced on this planner's topology
        (contention-free; Phase 2 re-prices the head under contention).
        Returns ``None`` when the plan doesn't survive the fleet change.
        """
        part = self.partitioner
        wl = dataclasses.replace(workload,
                                 microbatch_size=plan.microbatch_size)
        if workload.global_batch % max(plan.microbatch_size, 1):
            return None
        cm = CostModel(part.graph, self.topo, wl)
        n_nodes = len(part.graph.nodes)
        stages = []
        for s in plan.stages:
            if any(i >= n_nodes for i in s.node_ids):
                return None     # planned against a different model graph
            if mapping is None:
                devs = list(s.devices)
            else:
                devs = [mapping[d] for d in s.devices if d in mapping]
            if not devs:
                return None     # the whole stage departed
            st = cm.make_stage(list(s.node_ids), devs)
            if not cm.memory_feasible(st, self.qoe, n_stages_hint=4):
                return None     # survivors can't absorb the lost device
            stages.append(st)
        new = cm.evaluate(stages, self.qoe, part.config.schedule)
        new.meta["warm"] = True
        w_prev = plan.meta.get("chunks")
        if isinstance(w_prev, int):
            new.meta["chunks"] = w_prev
        return new
