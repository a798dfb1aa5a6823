# A copy of src/repro/fleet/planner.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's fleet plans must match the reference's to the last bit.
"""Joint device-assignment search for multi-tenant fleets.

``FleetPlanner`` partitions one shared fleet's devices among N tenant
workloads (exclusive devices, fluid-fair shared links) and plans each
tenant with any registered :class:`~repro_torch.strategies.PlannerStrategy`
against its allotment.  The search runs in two passes, mirroring the
single-tenant Phase-1/Phase-2 split:

1. **Proxy scoring** — every feasible assignment (each tenant gets at
   least one device, every device is assigned) is scored with a cheap
   contention-free strategy (``chain_split`` by default, ~1 ms per
   allotment, memoized per tenant x allotment).  Fleets too large to
   enumerate fall back to a demand-greedy seed plus single-device-move
   hill climbing under the same proxy.
2. **Refinement** — the best ``refine_k`` assignments are planned for
   real (per-tenant strategy, full Phase-1+2 for ``dora``), again
   memoized, and the joint winner is picked lexicographically:
   fewest QoE violations, then least total violation overshoot, then
   minimum total per-request energy, then maximum latency headroom.

Rebalancing reuses the same search: ``plan(devices=..., warm=...,
conditions=...)`` restricts the partition to the surviving fleet,
warm-starts each dora tenant from its previous candidate pool
(:meth:`DoraPlanner.replan`), and — when accumulated runtime conditions
are supplied — re-prices every scored plan under them so a throttled
device loses assignments it can no longer serve.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ..core.adapter import AdapterConfig, RuntimeState
from ..core.cost_model import CostProvider, resolve_costs
from ..core.device import Topology
from ..core.partitioner import PartitionerConfig
from ..core.planner import DoraPlanner
from ..core.plans import ParallelismPlan
from ..core.scheduler import NetworkScheduler, SchedulerConfig
from ..dora import PlanReport, _json_num, _plan_dict
from ..scenarios import Scenario, get_scenario
from ..strategies import get_strategy

#: An assignment: tenant index per fleet-device slot (aligned with the
#: ``devices`` list the search runs over).
Assignment = Tuple[int, ...]


@dataclasses.dataclass
class FleetConfig:
    """Knobs of the assignment search."""

    proxy_strategy: str = "chain_split"  # cheap pass-1 scorer
    refine_k: int = 4                    # assignments planned for real
    max_assignments: int = 4096          # enumeration cap -> local search
    search_budget: int = 200             # proxy evals for local search
    objective: str = "energy"            # "energy" | "headroom" first
    rebalance_on_load: bool = True       # FleetSession: rebalance when a
    #                                      load shift breaks a tenant's QoE


@dataclasses.dataclass
class TenantPlan:
    """One tenant's share of a fleet plan."""

    scenario: Scenario
    allotment: Tuple[int, ...]      # fleet device ids, sorted
    mapping: Dict[int, int]         # fleet id -> tenant-local id
    report: PlanReport              # planned on the allotment topology
    exclusive: bool = True          # False for the independent baseline

    @property
    def plan(self) -> ParallelismPlan:
        return self.report.best

    @property
    def feasible(self) -> bool:
        return self.report.meets_qoe

    @property
    def latency(self) -> float:
        return self.report.latency

    @property
    def energy(self) -> float:
        return self.report.energy

    def to_dict(self) -> Dict[str, object]:
        return {
            "tenant": self.scenario.name,
            "model": self.scenario.model_name,
            "mode": self.scenario.mode,
            "allotment": list(self.allotment),
            "exclusive": self.exclusive,
            "strategy": self.report.strategy,
            "latency_s": _json_num(self.latency),
            "energy_j": _json_num(self.energy),
            "meets_qoe": self.feasible,
            "t_qoe_s": _json_num(self.scenario.qoe.t_qoe),
            "best": _plan_dict(self.plan),
        }


@dataclasses.dataclass
class FleetPlan:
    """The joint plan: every tenant's allotment + per-tenant report."""

    name: str
    topology: Topology                       # calibrated shared fleet
    tenants: "OrderedDict[str, TenantPlan]"
    exclusive: bool = True
    planning_s: float = 0.0
    searched: int = 0                        # assignments proxy-scored
    refined: int = 0                         # assignments fully planned

    @property
    def feasible(self) -> bool:
        return all(t.feasible for t in self.tenants.values())

    @property
    def total_energy(self) -> float:
        """Sum of per-request (per-iteration) plan energies."""
        return sum(t.energy for t in self.tenants.values())

    @property
    def headroom(self) -> float:
        """Worst tenant's relative latency slack vs its QoE target."""
        return min((_headroom(t.scenario.qoe.t_qoe, t.latency)
                    for t in self.tenants.values()), default=1.0)

    @property
    def assignments(self) -> Dict[str, Tuple[int, ...]]:
        return {name: t.allotment for name, t in self.tenants.items()}

    def tenant(self, name: str) -> TenantPlan:
        return self.tenants[name]

    def to_dict(self) -> Dict[str, object]:
        return {
            "fleet": self.name,
            "devices": self.topology.n,
            "exclusive": self.exclusive,
            "feasible": self.feasible,
            "total_energy_j": _json_num(self.total_energy),
            "headroom": _json_num(self.headroom),
            "planning_s": _json_num(self.planning_s),
            "assignments_searched": self.searched,
            "assignments_refined": self.refined,
            "tenants": {name: t.to_dict()
                        for name, t in self.tenants.items()},
        }

    def summary(self) -> str:
        word = "co-planned" if self.exclusive else "independent"
        lines = [f"fleet {self.name} ({word}): {len(self.tenants)} tenants "
                 f"on {self.topology.n} devices, "
                 f"{'all QoE-feasible' if self.feasible else 'QoE VIOLATED'}"
                 f", total energy {self.total_energy:.2f} J/req, "
                 f"headroom {self.headroom:+.0%}"]
        for name, t in self.tenants.items():
            lines.append(
                f"  {name:24s} devs={list(t.allotment)!s:14s} "
                f"lat={t.latency * 1e3:8.1f} ms (t_qoe "
                f"{t.scenario.qoe.t_qoe:g}s) E={t.energy:7.2f} J  "
                f"{'OK' if t.feasible else 'MISS'}")
        return "\n".join(lines)


def _headroom(t_qoe: float, latency: float) -> float:
    if not math.isfinite(t_qoe) or t_qoe <= 0.0:
        return 1.0
    return (t_qoe - latency) / t_qoe


@dataclasses.dataclass(frozen=True)
class _Score:
    """One tenant's contribution to the joint objective."""

    feasible: bool
    overshoot: float        # QoE-violation seconds (inf: planning failed)
    energy: float
    headroom: float


class FleetPlanner:
    """Co-plan N tenant workloads on one shared topology."""

    def __init__(self, topology: Topology,
                 tenants: Sequence[Union[str, Scenario]], *,
                 name: str = "fleet",
                 strategy: Union[str, Dict[str, str]] = "dora",
                 config: Optional[FleetConfig] = None,
                 partitioner_config: Optional[PartitionerConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 adapter_config: Optional[AdapterConfig] = None,
                 costs: Optional[CostProvider] = None):
        self.tenants = [get_scenario(t) for t in tenants]
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        if not self.tenants:
            raise ValueError("fleet planning needs at least one tenant")
        self.name = name
        # calibrate the shared fleet ONCE; tenant subsets inherit the
        # calibrated rates, so tenant planners run with identity costs
        # (re-calibrating a subset would double-apply a measured provider)
        self.topo = resolve_costs(costs).calibrate(topology)
        if len(self.tenants) > self.topo.n:
            raise ValueError(
                f"{len(self.tenants)} tenants cannot each get an exclusive "
                f"device on a {self.topo.n}-device fleet")
        self.config = config or FleetConfig()
        self.strategy = strategy
        self.partitioner_config = partitioner_config
        self.scheduler_config = scheduler_config
        self.adapter_config = adapter_config
        self.graphs = {t.name: t.build_graph() for t in self.tenants}
        # memos keyed by (tenant, allotment, link-share factors, conditions)
        self._proxy_cache: Dict[tuple, Optional[_Score]] = {}
        self._plan_cache: Dict[tuple, Optional[PlanReport]] = {}

    def strategy_for(self, tenant: str) -> str:
        if isinstance(self.strategy, dict):
            return self.strategy.get(tenant, "dora")
        return self.strategy

    # -- tenant topology ----------------------------------------------------------
    def link_shares(self, allotments: Sequence[Tuple[int, ...]]
                    ) -> Dict[str, int]:
        """How many tenants transfer over each shared resource.

        A tenant occupies a shared medium iff at least two of its
        devices are members (single-device tenants never transfer).
        Dedicated pair links are exclusive by construction — both
        endpoints always belong to one tenant's allotment or the link
        dies in the subset.
        """
        users: Dict[str, int] = {}
        for r in self.topo.resources.values():
            if not r.shared:
                continue
            n = sum(1 for a in allotments
                    if len(r.members.intersection(a)) >= 2)
            if n:
                users[r.name] = n
        return users

    def tenant_topology(self, allotment: Tuple[int, ...],
                        shares: Dict[str, int]
                        ) -> Tuple[Topology, Dict[int, int]]:
        """The allotment's topology with shared links priced at their
        fluid-fair cross-tenant share."""
        sub, mapping = self.topo.subset(allotment)
        factors = {name: 1.0 / n for name, n in shares.items()
                   if n > 1 and name in sub.resources}
        if factors:
            sub = sub.scale_resources(factors)
        return sub, mapping

    def _factors_key(self, allotment: Tuple[int, ...],
                     shares: Dict[str, int]) -> tuple:
        return tuple(sorted((name, n) for name, n in shares.items()
                            if n > 1))

    # -- joint objective ---------------------------------------------------------
    def _score_of(self, qoe, plan: ParallelismPlan) -> _Score:
        return _Score(feasible=qoe.satisfied(plan),
                      overshoot=max(0.0, plan.latency - qoe.t_qoe),
                      energy=plan.energy,
                      headroom=_headroom(qoe.t_qoe, plan.latency))

    _FAILED = _Score(feasible=False, overshoot=math.inf, energy=math.inf,
                     headroom=-math.inf)

    def _joint_key(self, scores: Sequence[_Score]) -> tuple:
        violations = sum(1 for s in scores if not s.feasible)
        overshoot = sum(s.overshoot for s in scores)
        energy = sum(s.energy for s in scores)
        headroom = min((s.headroom for s in scores), default=1.0)
        if self.config.objective == "headroom":
            return (violations, overshoot, -headroom, energy)
        return (violations, overshoot, energy, -headroom)

    # -- pass 1: proxy scoring ----------------------------------------------------
    def _proxy(self, tenant: Scenario, allotment: Tuple[int, ...],
               shares: Dict[str, int],
               conditions: Optional[RuntimeState]) -> _Score:
        key = (tenant.name, allotment, self._factors_key(allotment, shares),
               _conditions_key(conditions))
        if key in self._proxy_cache:
            return self._proxy_cache[key] or self._FAILED
        score: Optional[_Score] = None
        try:
            # subset() raises when the allotment disconnects a routed
            # topology (star leaves without their hub, mesh fragments);
            # such allotments are infeasible, not fatal
            sub, mapping = self.tenant_topology(allotment, shares)
            result = get_strategy(self.config.proxy_strategy).plan(
                self.graphs[tenant.name], sub, tenant.qoe, tenant.workload)
            plan = result.best
            if conditions is not None:
                plan = NetworkScheduler(sub, tenant.qoe,
                                        self.scheduler_config).evaluate_fair(
                    plan, **_translate(conditions, mapping, sub))
            score = self._score_of(tenant.qoe, plan)
        except Exception:  # noqa: BLE001 — infeasible allotment, score it so
            score = None
        self._proxy_cache[key] = score
        return score or self._FAILED

    # -- pass 2: full planning -----------------------------------------------------
    def _plan_tenant(self, tenant: Scenario, allotment: Tuple[int, ...],
                     shares: Dict[str, int],
                     warm: Optional[Tuple[Sequence[ParallelismPlan],
                                          Tuple[int, ...]]] = None,
                     memo: Optional[Dict[tuple, Optional[PlanReport]]] = None
                     ) -> Optional[PlanReport]:
        key = (tenant.name, allotment,
               self._factors_key(allotment, shares))
        # warm results depend on the candidate pool of the *current*
        # rebalance, so they dedupe only within this plan() call
        # (``memo``) and never touch the cross-call memo — a stale
        # pool's plan must never be replayed for a later rebalance
        cache = self._plan_cache if warm is None else memo
        if cache is not None and key in cache:
            return cache[key]
        strat_name = self.strategy_for(tenant.name)
        report: Optional[PlanReport] = None
        try:
            # subset() raises on disconnecting allotments — infeasible
            sub, mapping = self.tenant_topology(allotment, shares)
            if strat_name == "dora":
                planner = DoraPlanner(
                    self.graphs[tenant.name], sub, tenant.qoe,
                    partitioner_config=self.partitioner_config,
                    scheduler_config=self.scheduler_config,
                    adapter_config=self.adapter_config)
                if warm is not None:
                    pool, prev_allot = warm
                    trans = {pos: mapping[orig]
                             for pos, orig in enumerate(prev_allot)
                             if orig in mapping}
                    result = planner.replan(tenant.workload, list(pool),
                                            mapping=trans)
                else:
                    result = planner.plan(tenant.workload)
            else:
                result = get_strategy(strat_name).plan(
                    self.graphs[tenant.name], sub, tenant.qoe,
                    tenant.workload)
            report = PlanReport(scenario=tenant, topology=sub,
                                graph=self.graphs[tenant.name],
                                workload=tenant.workload, qoe=tenant.qoe,
                                result=result, strategy=strat_name)
        except Exception:  # noqa: BLE001 — allotment can't host the tenant
            report = None
        if cache is not None:
            cache[key] = report
        return report

    # -- assignment enumeration -----------------------------------------------------
    def _exhaustive(self, n: int, k: int) -> Iterable[Assignment]:
        for combo in itertools.product(range(k), repeat=n):
            if len(set(combo)) == k:
                yield combo

    def _demand(self, tenant: Scenario) -> float:
        flops = self.graphs[tenant.name].total_flops_fwd
        rate = tenant.request_rate or 1.0
        return max(flops, 1.0) * rate

    def _local_search(self, devices: List[int], k: int,
                      score_fn) -> List[Assignment]:
        """Demand-greedy seed + single-device-move hill climbing under
        the proxy score, for fleets too large to enumerate."""
        order = sorted(range(len(devices)),
                       key=lambda i:
                       -self.topo.devices[devices[i]].effective_flops())
        demand = [self._demand(t) for t in self.tenants]
        got = [0.0] * k
        seed = [0] * len(devices)
        for slot in order:
            flops = self.topo.devices[devices[slot]].effective_flops()
            tenant = max(range(k),
                         key=lambda t: demand[t] / (got[t] + flops))
            seed[slot] = tenant
            got[tenant] += flops
        for t in range(k):             # everyone gets at least one device
            if t not in seed:
                seed[order[t % len(order)]] = t
        current = tuple(seed)
        if len(set(current)) != k:     # tiny fleets: round-robin fallback
            current = tuple(i % k for i in range(len(devices)))
        scores: Dict[Assignment, tuple] = {current: score_fn(current)}
        best_key = scores[current]
        improved = True
        while improved and len(scores) < self.config.search_budget:
            improved = False
            for slot in range(len(devices)):
                for t in range(k):
                    cand = list(current)
                    if cand[slot] == t:
                        continue
                    old = cand[slot]
                    cand[slot] = t
                    cand = tuple(cand)
                    if old not in cand or cand in scores:
                        continue       # would empty a tenant / already seen
                    scores[cand] = key = score_fn(cand)
                    if key < best_key:
                        current, best_key, improved = cand, key, True
                    if len(scores) >= self.config.search_budget:
                        break
                if len(scores) >= self.config.search_budget:
                    break
        return sorted(scores, key=scores.__getitem__)

    # -- the search -----------------------------------------------------------------
    def plan(self, devices: Optional[Sequence[int]] = None,
             warm: Optional[Dict[str, Tuple[Sequence[ParallelismPlan],
                                            Tuple[int, ...]]]] = None,
             conditions: Optional[RuntimeState] = None,
             include: Optional[Sequence[Dict[str, Tuple[int, ...]]]] = None
             ) -> FleetPlan:
        """Search device assignments and co-plan every tenant.

        ``devices`` restricts the partition to a surviving sub-fleet
        (fleet ids; default: the whole fleet).  ``warm`` maps tenant
        names to ``(candidate pool, previous allotment)`` pairs for
        §4.3-style warm-started replans.  ``conditions`` re-prices all
        scored plans under accumulated runtime state, so rebalancing
        sees degraded devices as degraded.  ``include`` forces specific
        assignments (e.g. the incumbent) into the fully-planned set.
        """
        t0 = time.perf_counter()
        devs = sorted(set(devices)) if devices is not None \
            else list(range(self.topo.n))
        bad = [d for d in devs if not (0 <= d < self.topo.n)]
        if bad:
            raise ValueError(f"unknown fleet devices {bad} "
                             f"(fleet has {self.topo.n})")
        k = len(self.tenants)
        if k > len(devs):
            raise ValueError(f"{k} tenants need at least {k} devices; "
                             f"only {devs} survive")

        def allotments_of(a: Assignment) -> List[Tuple[int, ...]]:
            return [tuple(d for d, t in zip(devs, a) if t == i)
                    for i in range(k)]

        searched = 0

        def proxy_key(a: Assignment) -> tuple:
            nonlocal searched
            searched += 1
            allots = allotments_of(a)
            shares = self.link_shares(allots)
            return self._joint_key([
                self._proxy(t, allot, shares, conditions)
                for t, allot in zip(self.tenants, allots)])

        if k ** len(devs) <= self.config.max_assignments:
            ranked = sorted(self._exhaustive(len(devs), k), key=proxy_key)
        else:
            ranked = self._local_search(devs, k, proxy_key)
        head = ranked[:max(self.config.refine_k, 1)]
        for forced in (include or ()):
            a = _as_assignment(forced, devs,
                               [t.name for t in self.tenants])
            if a is not None and a not in head:
                head.append(a)

        best_key, best_entry = None, None
        refined = 0
        call_memo: Dict[tuple, Optional[PlanReport]] = {}
        for a in head:
            allots = allotments_of(a)
            shares = self.link_shares(allots)
            entry: "OrderedDict[str, TenantPlan]" = OrderedDict()
            scores: List[_Score] = []
            for tenant, allot in zip(self.tenants, allots):
                report = self._plan_tenant(
                    tenant, allot, shares,
                    warm=(warm or {}).get(tenant.name), memo=call_memo)
                if report is None:
                    scores.append(self._FAILED)
                    continue
                plan = report.best
                if conditions is not None:
                    sub = report.topology
                    mapping = {orig: pos
                               for pos, orig in enumerate(allot)}
                    plan = NetworkScheduler(
                        sub, tenant.qoe, self.scheduler_config).refine(
                        plan, **_translate(conditions, mapping, sub))
                scores.append(self._score_of(tenant.qoe, plan))
                entry[tenant.name] = TenantPlan(
                    scenario=tenant, allotment=allot,
                    mapping={orig: pos for pos, orig in enumerate(allot)},
                    report=report)
            refined += 1
            if len(entry) < k:      # a tenant failed to plan: skip unless
                if best_entry is not None:      # nothing better exists
                    continue
            key = self._joint_key(scores)
            if best_key is None or key < best_key:
                best_key, best_entry = key, entry
        if not best_entry or len(best_entry) < k:
            missing = [t.name for t in self.tenants
                       if t.name not in (best_entry or {})]
            raise RuntimeError(
                f"no assignment of {devs} hosts every tenant "
                f"(QoE-feasibly plannable allotment missing for "
                f"{missing})")
        return FleetPlan(name=self.name, topology=self.topo,
                         tenants=best_entry,
                         planning_s=time.perf_counter() - t0,
                         searched=searched, refined=refined)


def _conditions_key(conditions: Optional[RuntimeState]) -> tuple:
    if conditions is None:
        return ()
    return (tuple(sorted(conditions.compute_speed.items())),
            tuple(sorted(conditions.bandwidth_scale.items())))


def _translate(conditions: RuntimeState, mapping: Dict[int, int],
               sub: Topology) -> Dict[str, Dict]:
    """Fleet-space runtime state -> tenant-local refine() keywords."""
    return {
        "compute_speed": {mapping[d]: v
                          for d, v in conditions.compute_speed.items()
                          if d in mapping},
        "bandwidth_scale": {r: v
                            for r, v in conditions.bandwidth_scale.items()
                            if r in sub.resources},
    }


def _as_assignment(assignment: Dict[str, Tuple[int, ...]],
                   devs: List[int], names: List[str]
                   ) -> Optional[Assignment]:
    """{tenant: allotment} -> tenant-index-per-device tuple, or ``None``
    when it doesn't cover exactly the searched devices."""
    owner: Dict[int, int] = {}
    for i, name in enumerate(names):
        for d in assignment.get(name, ()):
            if d in owner:
                return None
            owner[d] = i
    if sorted(owner) != devs:
        return None
    return tuple(owner[d] for d in devs)


# -- the "no co-planning" baseline ------------------------------------------------
def plan_independent(topology: Topology,
                     tenants: Sequence[Union[str, Scenario]], *,
                     name: str = "fleet",
                     strategy: Union[str, Dict[str, str]] = "dora",
                     partitioner_config: Optional[PartitionerConfig] = None,
                     scheduler_config: Optional[SchedulerConfig] = None,
                     costs: Optional[CostProvider] = None) -> FleetPlan:
    """What happens *without* the fleet layer: every tenant plans alone
    on the full fleet, then they all run at once.

    Each tenant's plan is then re-priced under fluid-fair interference:
    a device placed in ``k`` tenants' plans serves each at ``1/k`` of
    its cycles, and a shared link carrying ``u`` tenants' transfers
    gives each ``1/u`` of its bandwidth — the same fluid model the
    Phase-2 scheduler uses for unscheduled contention (Fig. 2).  The
    result is a :class:`FleetPlan` with ``exclusive=False`` and
    overlapping allotments, directly comparable with
    :meth:`FleetPlanner.plan` — the fig_fleet benchmark's baseline.
    """
    scs = [get_scenario(t) for t in tenants]
    topo = resolve_costs(costs).calibrate(topology)
    t0 = time.perf_counter()
    reports: "OrderedDict[str, PlanReport]" = OrderedDict()
    for sc in scs:
        strat = strategy.get(sc.name, "dora") if isinstance(strategy, dict) \
            else strategy
        graph = sc.build_graph()
        if strat == "dora":
            planner = DoraPlanner(graph, topo, sc.qoe,
                                  partitioner_config=partitioner_config,
                                  scheduler_config=scheduler_config)
            result = planner.plan(sc.workload)
        else:
            result = get_strategy(strat).plan(graph, topo, sc.qoe,
                                              sc.workload)
        reports[sc.name] = PlanReport(scenario=sc, topology=topo,
                                      graph=graph, workload=sc.workload,
                                      qoe=sc.qoe, result=result,
                                      strategy=strat)
    # fluid-fair interference: count tenants per device / shared medium
    dev_users: Dict[int, int] = {}
    for rep in reports.values():
        for d in set(rep.best.devices):
            dev_users[d] = dev_users.get(d, 0) + 1
    link_users: Dict[str, int] = {}
    for r in topo.resources.values():
        if not r.shared:
            continue
        n = sum(1 for rep in reports.values()
                if len(r.members.intersection(rep.best.devices)) >= 2)
        if n:
            link_users[r.name] = n
    tenants_out: "OrderedDict[str, TenantPlan]" = OrderedDict()
    for sc in scs:
        rep = reports[sc.name]
        speed = {d: 1.0 / dev_users[d] for d in set(rep.best.devices)
                 if dev_users[d] > 1}
        bw = {rn: 1.0 / u for rn, u in link_users.items() if u > 1}
        if speed or bw:
            contended = NetworkScheduler(topo, sc.qoe,
                                         scheduler_config).refine(
                rep.best, compute_speed=speed, bandwidth_scale=bw)
            result = dataclasses.replace(rep.result, best=contended,
                                         candidates=[contended],
                                         pareto=[contended])
            rep = dataclasses.replace(rep, result=result)
        tenants_out[sc.name] = TenantPlan(
            scenario=sc, allotment=tuple(sorted(set(rep.best.devices))),
            mapping={d: d for d in range(topo.n)}, report=rep,
            exclusive=False)
    return FleetPlan(name=name, topology=topo, tenants=tenants_out,
                     exclusive=False, planning_s=time.perf_counter() - t0,
                     searched=0, refined=len(tenants_out))
