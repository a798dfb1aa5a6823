# A copy of src/repro/strategies/baselines.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Baseline hybrid-parallelism planners (§6.1) + brute-force optimal.

Each baseline reproduces the *planning assumptions* of the cited system;
the strategy wrappers then price every plan on the REAL topology under
fluid-shared contention (what a contention-oblivious plan actually
suffers, Fig. 2):

* ``edgeshard`` — pipeline-only, even layer split, one device per
  stage, memory-oblivious (EdgeShard [33]; OOMs in Traffic Monitor).
* ``asteroid``  — heterogeneity-aware hybrid PP+DP maximizing raw
  throughput under idealized contention-free D2D links (Asteroid [30]).
* ``alpa``      — DP/PP/TP automation assuming HOMOGENEOUS devices
  and uniform bandwidth (Alpa [38]): stages balanced for the mean
  device, uniform microbatch split.
* ``metis``     — heterogeneity-aware load balancing (Metis [26])
  but with a uniform, contention-free network model.
* ``brute_force`` — exhaustive search over (contiguous stage splits ×
  ordered device groupings), each shortlisted candidate executed under
  the real contention model ("Optimal" in Fig. 2).

The plain ``*_plan`` functions remain importable (``repro_torch.sim`` keeps
re-exporting them), but all benchmark/facade resolution goes through the
strategy registry (:mod:`repro_torch.strategies.base`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.cost_model import CostModel, CostProvider, Workload, resolve_costs
from ..core.device import DeviceProfile, LinkResource, Topology
from ..core.partitioner import ModelPartitioner, PartitionerConfig
from ..core.planner import PlanningResult
from ..core.planning_graph import ModelGraph
from ..core.plans import ParallelismPlan, Stage
from ..core.qoe import QoESpec
from .base import StrategyError, _Stopwatch, as_result, fair_executed, \
    register_strategy

LATENCY_ONLY = QoESpec(t_qoe=0.0, lam=1e15)   # objective ≈ pure latency

#: Back-compat alias — ``repro_torch.sim`` has always raised ``BaselineError``.
BaselineError = StrategyError


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------
def _uniform_split(devices: Sequence[int]) -> Dict[int, float]:
    return {d: 1.0 / len(devices) for d in devices}


def reprice_stage(cm: CostModel, st: Stage, topo: Topology) -> Stage:
    """Recompute stage times under the REAL device speeds for the stage's
    (possibly non-proportional) microbatch split: a replica group finishes
    when its slowest member does. Includes the weight-streaming roofline
    term (every replica reads the stage weights once per microbatch)."""
    t_f = t_b = 0.0
    w_read = st.param_bytes / max(st.tp_degree, 1)
    for d in st.devices:
        dev = topo.devices[d]
        share = st.microbatch_split[d]
        f = dev.effective_flops(st.tp_degree)
        t_f = max(t_f, st.flops_fwd * share / f, w_read / dev.mem_bw)
        if st.flops_bwd > 0:
            t_b = max(t_b, st.flops_bwd * share / f, 2.0 * w_read / dev.mem_bw)
    return dataclasses.replace(st, fwd_time=t_f, bwd_time=t_b)


def _contiguous_splits(n_items: int, n_parts: int) -> Iterable[Tuple[int, ...]]:
    """Yield sizes of contiguous partitions of n_items into n_parts ≥1 parts."""
    if n_parts == 1:
        yield (n_items,)
        return
    for first in range(1, n_items - n_parts + 2):
        for rest in _contiguous_splits(n_items - first, n_parts - 1):
            yield (first,) + rest


def _chain_nodes(graph: ModelGraph) -> List[int]:
    """Serialized node order (baselines treat the model as a chain)."""
    return graph.topological_order()


def _balance_boundaries(costs: Sequence[float], weights: Sequence[float]
                        ) -> List[int]:
    """Split ``costs`` into len(weights) contiguous groups with group cost
    ≈ proportional to ``weights`` (prefix-sum walk)."""
    total = sum(costs)
    targets = [w / sum(weights) * total for w in weights]
    sizes: List[int] = []
    i = 0
    for s, tgt in enumerate(targets):
        remaining_parts = len(targets) - s - 1
        acc = 0.0
        j = i
        # leave at least one node per remaining part
        while j < len(costs) - remaining_parts and (acc < tgt or j == i):
            nxt = acc + costs[j]
            if acc >= tgt * 0.5 and nxt > tgt * 1.5 and j > i:
                break
            acc = nxt
            j += 1
        sizes.append(j - i)
        i = j
    if i < len(costs):
        sizes[-1] += len(costs) - i
    return sizes


def _make_plan(graph: ModelGraph, topo: Topology, wl: Workload, qoe: QoESpec,
               groups: Sequence[Sequence[int]],
               device_groups: Sequence[Sequence[int]],
               uniform_split: bool = False,
               schedule: str = "1f1b") -> ParallelismPlan:
    cm = CostModel(graph, topo, wl)
    stages: List[Stage] = []
    for node_ids, devs in zip(groups, device_groups):
        st = cm.make_stage(list(node_ids), list(devs))
        if uniform_split:
            st = dataclasses.replace(st, microbatch_split=_uniform_split(devs))
            st = reprice_stage(cm, st, topo)
        stages.append(st)
    return cm.evaluate(stages, qoe, schedule)


def plan_memory_ok(plan: ParallelismPlan, topo: Topology
                   ) -> Tuple[bool, Optional[str]]:
    """True memory check against the plan's evaluated per-device usage
    (the evaluating schedule — GPipe vs 1F1B — already determined the
    in-flight activation count baked into ``per_device_memory``)."""
    for idx, (d, used) in enumerate(plan.per_device_memory.items()):
        if used > topo.devices[d].memory:
            return False, (f"device {d} ({topo.devices[d].name}) needs "
                           f"{used / 1e9:.1f} GB > {topo.devices[d].memory / 1e9:.1f} GB")
    return True, None


# ----------------------------------------------------------------------------
# EdgeShard — pipeline-only, even layer split, memory-oblivious
# ----------------------------------------------------------------------------
def edgeshard_plan(graph: ModelGraph, topo: Topology, wl: Workload,
                   n_stages: Optional[int] = None) -> ParallelismPlan:
    g = graph.compress(0.02)
    order = _chain_nodes(g)
    S = n_stages or topo.n
    S = min(S, len(order))
    sizes = [len(order) // S + (1 if i < len(order) % S else 0) for i in range(S)]
    groups, i = [], 0
    for sz in sizes:
        groups.append(order[i:i + sz])
        i += sz
    devs = [[d] for d in range(topo.n)][:S]
    # EdgeShard uses GPipe-style all-forward-then-backward microbatching:
    # stage 0 accumulates every in-flight activation.
    plan = _make_plan(g, topo, wl, LATENCY_ONLY, groups, devs,
                      schedule="gpipe")
    plan.meta["planner"] = "edgeshard"
    plan.meta["graph"] = g
    ok, why = plan_memory_ok(plan, topo)
    if not ok:
        raise BaselineError(f"EdgeShard plan OOM: {why}")
    return plan


# ----------------------------------------------------------------------------
# Asteroid — hybrid PP+DP, throughput-optimal under idealized D2D links
# ----------------------------------------------------------------------------
def _mb_sweep(wl: Workload) -> Tuple[int, ...]:
    """Microbatch candidates every planner may tune over."""
    out = {wl.microbatch_size} | {m for m in (1, 2, 4, 8, 16)
                                  if wl.global_batch % m == 0}
    return tuple(sorted(out))


def _zero_latency(topo: Topology) -> Topology:
    """The cited planners model link *bandwidth* only — per-message MAC/
    RTT latency is absent from their cost models."""
    res = [dataclasses.replace(r, latency=0.0) for r in topo.resources.values()]
    return Topology(topo.devices, res, topo._p2p)


def asteroid_plan(graph: ModelGraph, topo: Topology, wl: Workload,
                  top_k: int = 1) -> ParallelismPlan:
    cfg = PartitionerConfig(top_k=max(top_k, 1), delta=0.05,
                            microbatch_sizes=_mb_sweep(wl),
                            objective_mode="throughput")
    ideal_topo = _zero_latency(topo)      # idealized D2D view (§2.2, Fig. 2)
    part = ModelPartitioner(graph, ideal_topo, LATENCY_ONLY, cfg)
    cands = part.plan(wl)
    if not cands:
        raise BaselineError("Asteroid found no feasible plan")
    best = cands[0]
    best.meta["planner"] = "asteroid"
    best.meta["graph"] = part.graph
    return best


# ----------------------------------------------------------------------------
# Alpa — homogeneous-cluster automation (mean device, uniform bandwidth)
# ----------------------------------------------------------------------------
def _homogenized(topo: Topology) -> Topology:
    mean_flops = sum(d.flops for d in topo.devices) / topo.n
    mean_mem = sum(d.memory for d in topo.devices) / topo.n
    mean_eff = sum(d.compute_efficiency for d in topo.devices) / topo.n
    devs = [dataclasses.replace(d, flops=mean_flops, memory=mean_mem,
                                compute_efficiency=mean_eff)
            for d in topo.devices]
    return _uniform_net(devs, topo)


def _uniform_net(devs: Sequence[DeviceProfile], topo: Topology) -> Topology:
    """Every pair gets a dedicated link at the mean peak bandwidth —
    the 'uniform contention-free D2D' network model."""
    n = len(devs)
    caps = [topo.peak_bandwidth(i, j) for i in range(n) for j in range(n) if i != j]
    mean_bw = sum(caps) / len(caps) if caps else math.inf
    resources, p2p = [], {}
    for i in range(n):
        for j in range(i + 1, n):
            name = f"u{i}-{j}"
            resources.append(LinkResource(name, mean_bw, frozenset((i, j)),
                                          shared=False))
            p2p[(i, j)] = [name]
            p2p[(j, i)] = [name]
    return Topology(list(devs), resources, p2p)


def alpa_plan(graph: ModelGraph, topo: Topology, wl: Workload) -> ParallelismPlan:
    homo = _homogenized(topo)
    cfg = PartitionerConfig(top_k=1, delta=0.05,
                            microbatch_sizes=_mb_sweep(wl),
                            objective_mode="throughput")
    part = ModelPartitioner(graph, homo, LATENCY_ONLY, cfg)
    cands = part.plan(wl)
    if not cands:
        raise BaselineError("Alpa found no feasible plan")
    ideal = cands[0]
    # map back onto the REAL devices with a UNIFORM microbatch split (the
    # homogeneity assumption) and reprice under true speeds
    groups = [list(s.node_ids) for s in ideal.stages]
    dev_groups = [list(s.devices) for s in ideal.stages]
    wl = dataclasses.replace(wl, microbatch_size=ideal.microbatch_size)
    plan = _make_plan(part.graph, topo, wl, LATENCY_ONLY, groups, dev_groups,
                      uniform_split=True)
    plan.meta["planner"] = "alpa"
    plan.meta["graph"] = part.graph
    return plan


# ----------------------------------------------------------------------------
# Metis — heterogeneity-aware compute balance, uniform network model
# ----------------------------------------------------------------------------
def metis_plan(graph: ModelGraph, topo: Topology, wl: Workload) -> ParallelismPlan:
    uniform = _uniform_net(topo.devices, topo)
    cfg = PartitionerConfig(top_k=1, delta=0.05,
                            microbatch_sizes=_mb_sweep(wl),
                            objective_mode="throughput")
    part = ModelPartitioner(graph, uniform, LATENCY_ONLY, cfg)
    cands = part.plan(wl)
    if not cands:
        raise BaselineError("Metis found no feasible plan")
    ideal = cands[0]
    groups = [list(s.node_ids) for s in ideal.stages]
    dev_groups = [list(s.devices) for s in ideal.stages]
    wl = dataclasses.replace(wl, microbatch_size=ideal.microbatch_size)
    plan = _make_plan(part.graph, topo, wl, LATENCY_ONLY, groups, dev_groups)
    plan.meta["planner"] = "metis"
    plan.meta["graph"] = part.graph
    return plan


# ----------------------------------------------------------------------------
# Brute-force optimal (small settings; Fig. 2's "Optimal")
# ----------------------------------------------------------------------------
def _ordered_groupings(devices: List[int], n_groups: int
                       ) -> Iterable[List[List[int]]]:
    """Ordered partitions of a *speed-sorted* device list into contiguous
    groups (sufficient in practice: an optimal stage never benefits from
    pairing the fastest and slowest device when a middle one is free)."""
    for sizes in _contiguous_splits(len(devices), n_groups):
        out, i = [], 0
        for sz in sizes:
            out.append(devices[i:i + sz])
            i += sz
        yield out


def brute_force_optimal(graph: ModelGraph, topo: Topology, wl: Workload,
                        evaluate, max_stages: Optional[int] = None,
                        delta: float = 0.08, shortlist: int = 300
                        ) -> ParallelismPlan:
    """Exhaustive two-phase search ("Optimal" in Fig. 2).

    Enumerates (contiguous stage splits × ordered device groupings over
    speed-sorted devices), ranks all candidates by the cheap analytic
    latency, then REAL-evaluates the best ``shortlist`` with
    ``evaluate(plan) -> float`` (the contention-aware simulator) and
    returns the true winner.
    """
    g = graph.compress(delta)
    order = _chain_nodes(g)
    cands: List[ParallelismPlan] = []
    by_speed = sorted(range(topo.n),
                      key=lambda d: topo.devices[d].effective_flops(), reverse=True)
    dev_orders = [by_speed, list(reversed(by_speed))]
    S_cap = min(max_stages or topo.n, len(order), topo.n)
    for S in range(1, S_cap + 1):
        for sizes in _contiguous_splits(len(order), S):
            groups, i = [], 0
            for sz in sizes:
                groups.append(order[i:i + sz])
                i += sz
            seen_dg = set()
            for dev_order in dev_orders:
                for dgs in _ordered_groupings(dev_order, S):
                    key = tuple(tuple(sorted(dg)) for dg in dgs)
                    if key in seen_dg:
                        continue
                    seen_dg.add(key)
                    try:
                        plan = _make_plan(g, topo, wl, LATENCY_ONLY,
                                          groups, dgs)
                    except Exception:
                        continue
                    ok, _ = plan_memory_ok(plan, topo)
                    if not ok:
                        continue
                    plan.meta["graph"] = g
                    cands.append(plan)
    if not cands:
        raise BaselineError("brute force found no feasible plan")
    cands.sort(key=lambda p: p.latency)          # cheap analytic rank
    best: Optional[ParallelismPlan] = None
    best_lat = math.inf
    for plan in cands[:shortlist]:
        lat = evaluate(plan)
        if lat < best_lat:
            best_lat = lat
            plan.latency = lat
            plan.meta["planner"] = "optimal"
            best = plan
    assert best is not None
    return best


# ----------------------------------------------------------------------------
# strategy wrappers — the registry entries
# ----------------------------------------------------------------------------
class _SinglePlanBaseline:
    """Shared shape: run one ``*_plan`` function, price the result under
    fluid-fair contention on the calibrated real topology."""

    name = "abstract"
    contention_aware = False

    def _raw_plan(self, graph: ModelGraph, topo: Topology,
                  wl: Workload) -> ParallelismPlan:
        raise NotImplementedError

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        topo = resolve_costs(costs).calibrate(topology)
        watch = _Stopwatch()
        raw = self._raw_plan(graph, topo, workload)
        phase1_s = watch.lap()
        executed = fair_executed(raw, topo, qoe)
        return as_result([executed], phase1_s, watch.lap())


@register_strategy
class EdgeShardStrategy(_SinglePlanBaseline):
    """EdgeShard-like: pipeline-only even layer chain.

    The raw ``edgeshard_plan`` is memory-oblivious (the paper's reported
    failure mode); the registered strategy degrades like the real system
    would — if the full-fleet even split OOMs it retries with fewer
    stages and only raises when no even split fits at all.  Pass
    ``n_stages=`` to pin the stage count (no fallback)."""

    name = "edgeshard"

    def __init__(self, n_stages: Optional[int] = None):
        self.n_stages = n_stages

    def _raw_plan(self, graph, topo, wl):
        if self.n_stages is not None:
            return edgeshard_plan(graph, topo, wl, n_stages=self.n_stages)
        first_err: Optional[StrategyError] = None
        for S in range(topo.n, 0, -1):
            try:
                plan = edgeshard_plan(graph, topo, wl, n_stages=S)
            except StrategyError as e:
                first_err = first_err or e
                continue
            if S < topo.n:
                plan.meta["fallback_stages"] = S
            return plan
        raise first_err or StrategyError("edgeshard: no feasible even split")


@register_strategy
class AsteroidStrategy(_SinglePlanBaseline):
    """Asteroid-like: throughput-max hybrid PP+DP, idealized D2D links."""

    name = "asteroid"

    def __init__(self, top_k: int = 1):
        self.top_k = top_k

    def _raw_plan(self, graph, topo, wl):
        return asteroid_plan(graph, topo, wl, top_k=self.top_k)


@register_strategy
class AlpaStrategy(_SinglePlanBaseline):
    """Alpa-like: homogeneous-cluster automation, uniform split."""

    name = "alpa"

    def _raw_plan(self, graph, topo, wl):
        return alpa_plan(graph, topo, wl)


@register_strategy
class MetisStrategy(_SinglePlanBaseline):
    """Metis-like: heterogeneity-aware balance, uniform network model."""

    name = "metis"

    def _raw_plan(self, graph, topo, wl):
        return metis_plan(graph, topo, wl)


@register_strategy
class BruteForceStrategy:
    """Exhaustive split search, shortlisted candidates priced on the real
    contended medium ("Optimal" in Fig. 2).  ``evaluate`` defaults to the
    fluid-fair simulator; pass a callable to search under a different
    execution model."""

    name = "brute_force"
    contention_aware = True     # the shortlist IS evaluated under contention

    def __init__(self, max_stages: Optional[int] = None, delta: float = 0.08,
                 shortlist: int = 300,
                 evaluate: Optional[Callable[[ParallelismPlan], float]] = None):
        self.max_stages = max_stages
        self.delta = delta
        self.shortlist = shortlist
        self.evaluate = evaluate

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        topo = resolve_costs(costs).calibrate(topology)
        evaluate = self.evaluate or (
            lambda p: fair_executed(p, topo, qoe).latency)
        watch = _Stopwatch()
        best = brute_force_optimal(graph, topo, workload, evaluate,
                                   max_stages=self.max_stages,
                                   delta=self.delta, shortlist=self.shortlist)
        phase1_s = watch.lap()
        if self.evaluate is None:
            # fills energy/objective/schedule under the same fair model
            # the shortlist was ranked with
            best = fair_executed(best, topo, qoe)
        else:
            # honor the caller's execution model: keep its latency,
            # just refresh the objective for the comparison qoe
            best.objective = qoe.objective(best.energy, best.latency)
        return as_result([best], phase1_s, watch.lap())
