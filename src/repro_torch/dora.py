# A copy of src/repro/dora.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's facade must plan, serve and simulate as the reference's does.
"""``repro_torch.dora`` — the one-call facade over Dora's planning stack.

The three paper mechanisms (model partitioner §4.1, contention-aware
network scheduler §4.2, runtime adapter §4.3) are wired behind three
verbs, each taking a scenario name (or an ad-hoc
:class:`repro_torch.scenarios.Scenario`):

    from repro_torch import dora

    report  = dora.plan("smart_home_2")          # -> PlanReport
    session = dora.serve("traffic_monitor")      # -> ServeSession (adapter)
    trace   = dora.simulate("vehicle_platoon")   # -> SimulationTrace

``plan`` runs Algorithm 1 end to end (partition → schedule → Pareto
filter); ``serve`` additionally arms the runtime adapter for dynamics;
``simulate`` replays a timeline of :class:`DynamicsEvent`\\ s through the
adapter and records every reaction.  Every knob of the underlying stack
remains reachable through keyword overrides (``workload=``, ``qoe=``,
``graph=``, ``topology=``, ``partitioner_config=``, ...), so the facade
never forces a drop back down to hand-wiring ``DoraPlanner``.

Planners themselves are pluggable: ``plan`` takes a ``strategy=`` from
the ``repro_torch.strategies`` registry (``"dora"``, ``"throughput_max"``,
``"chain_split"``, ``"pareto_split"``, the §6.1 baselines, ...), and
``compare`` runs several strategies on one scenario and tabulates
latency/energy/QoE with speedup-vs-baseline columns::

    cmp = dora.compare("smart_home_2",
                       strategies=["dora", "throughput_max", "chain_split"])
    print(cmp.summary()); cmp.to_json("compare.json")

Cost fidelity is pluggable too: every verb accepts ``costs=`` — a
``CostProvider`` instance, the string ``"analytic"`` (datasheet
rooflines, the default), or ``"profiled:<path>"`` to load a committed
:class:`repro_torch.core.profiler.ProfiledCosts` calibration artifact::

    report = dora.plan("smart_home_2", costs="profiled:calibration/host_cpu.json")

``dora.calibrate()`` produces such artifacts by microbenchmarking the
local host (see :mod:`repro_torch.calibrate`).

This module is deliberately jax-free: planning is analytic, so importing
``repro_torch.dora`` never initializes an accelerator backend.
"""
from __future__ import annotations

import copy as _copy
import dataclasses
import json
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .control.plane import ControlConfig, ControlPlane
from .core.adapter import (AdapterConfig, DynamicsEvent, RuntimeAdapter,
                           RuntimeState)
from .core.cost_model import CostProvider, Workload
from .core.device import Topology
from .core.partitioner import PartitionerConfig
from .core.planner import DoraPlanner, PlanningResult
from .core.planning_graph import ModelGraph
from .core.plans import ParallelismPlan
from .core.qoe import QoESpec
from .core.scheduler import SchedulerConfig
from .scenarios import Scenario, get_scenario
from .strategies import StrategyRef, get_strategy

ScenarioRef = Union[str, Scenario]

# (label, event) or bare event — both accepted by simulate().
TimelineItem = Union[DynamicsEvent, Tuple[str, DynamicsEvent]]

#: Default strategy line-up for ``dora.compare``.
DEFAULT_COMPARISON = ("dora", "throughput_max", "chain_split", "pareto_split")


# JSON-safe number coercion lives with the serving kernel now; the
# old name stays importable from here (several modules and tests do).
from .core.events import _json_num  # noqa: E402,F401


def _plan_dict(plan: ParallelismPlan) -> Dict[str, object]:
    """Machine-readable summary of one plan (JSON-safe)."""
    return {
        "latency_s": _json_num(plan.latency),
        "energy_j": _json_num(plan.energy),
        "objective": _json_num(plan.objective),
        "microbatch_size": plan.microbatch_size,
        "n_microbatches": plan.n_microbatches,
        "training": plan.training,
        "stages": [{
            "n_nodes": len(s.node_ids),
            "devices": list(s.devices),
            "dp_degree": s.dp_degree,
            "tp_degree": s.tp_degree,
        } for s in plan.stages],
        "per_device_energy_j":
            {str(d): _json_num(e) for d, e in plan.per_device_energy.items()},
        "per_device_memory_gb":
            {str(d): _json_num(m / 1e9)
             for d, m in plan.per_device_memory.items()},
    }


@dataclasses.dataclass
class PlanReport:
    """Everything ``dora.plan`` produced for one scenario, in one object."""

    scenario: Scenario
    topology: Topology
    graph: ModelGraph
    workload: Workload
    qoe: QoESpec
    result: PlanningResult
    strategy: str = "dora"

    @property
    def best(self) -> ParallelismPlan:
        return self.result.best

    @property
    def candidates(self) -> List[ParallelismPlan]:
        return self.result.candidates

    @property
    def pareto(self) -> List[ParallelismPlan]:
        return self.result.pareto

    @property
    def latency(self) -> float:
        return self.result.best.latency

    @property
    def energy(self) -> float:
        return self.result.best.energy

    @property
    def meets_qoe(self) -> bool:
        """Full QoE verdict (latency target AND energy/memory budgets)."""
        return self.qoe.satisfied(self.result.best)

    @property
    def planning_seconds(self) -> float:
        return self.result.total_s

    def to_dict(self) -> Dict[str, object]:
        """Machine-readable report (strict-JSON-safe) for ``--json``
        artifacts and future ``BENCH_*.json`` trajectories."""
        return {
            "scenario": self.scenario.name,
            "mode": self.scenario.mode,
            "model": self.scenario.model_name,
            "strategy": self.strategy,
            "devices": self.topology.n,
            "qoe": {"t_qoe_s": _json_num(self.qoe.t_qoe),
                    "e_qoe_j": _json_num(self.qoe.e_qoe),
                    "lam": _json_num(self.qoe.lam)},
            "latency_s": _json_num(self.latency),
            "energy_j": _json_num(self.energy),
            "meets_qoe": self.meets_qoe,
            "planning_s": _json_num(self.planning_seconds),
            "best": _plan_dict(self.best),
            "pareto": [{"latency_s": _json_num(p.latency),
                        "energy_j": _json_num(p.energy)}
                       for p in self.pareto],
        }

    def summary(self) -> str:
        lines = [
            f"scenario {self.scenario.name} [{self.scenario.mode}] "
            f"model={self.scenario.model_name} devices={self.topology.n} "
            f"strategy={self.strategy}",
            f"planned in {self.result.total_s:.2f}s "
            f"(phase1 {self.result.phase1_s:.2f}s + "
            f"phase2 {self.result.phase2_s:.2f}s)",
            f"best: {self.best.summary()}",
            f"QoE target {self.qoe.t_qoe:g}s: "
            f"{'MET' if self.meets_qoe else 'VIOLATED'} "
            f"({self.latency:.3f}s, {self.energy:.1f} J)",
            f"pareto frontier ({len(self.pareto)} plans for runtime mixing):",
        ]
        for p in self.pareto:
            lines.append(f"  lat={p.latency * 1e3:9.1f} ms  "
                         f"energy={p.energy:9.1f} J  "
                         f"stages={p.n_stages} mb={p.microbatch_size}")
        return "\n".join(lines)


def _resolve(scenario: ScenarioRef,
             topology: Optional[Topology],
             graph: Optional[ModelGraph],
             workload: Optional[Workload],
             qoe: Optional[QoESpec],
             seq_len: Optional[int]
             ) -> Tuple[Scenario, Topology, ModelGraph, Workload, QoESpec]:
    sc = get_scenario(scenario)
    topo = topology if topology is not None else sc.build_topology()
    wl = workload if workload is not None else sc.workload
    q = qoe if qoe is not None else sc.qoe
    g = graph if graph is not None else sc.build_graph(seq_len=seq_len)
    return sc, topo, g, wl, q


def planner_for(scenario: ScenarioRef, *,
                topology: Optional[Topology] = None,
                graph: Optional[ModelGraph] = None,
                workload: Optional[Workload] = None,
                qoe: Optional[QoESpec] = None,
                seq_len: Optional[int] = None,
                partitioner_config: Optional[PartitionerConfig] = None,
                scheduler_config: Optional[SchedulerConfig] = None,
                adapter_config: Optional[AdapterConfig] = None,
                costs: Optional[CostProvider] = None
                ) -> Tuple[DoraPlanner, Scenario, Workload]:
    """Construct (planner, scenario, workload) without running it —
    the escape hatch for callers that sweep planner configurations."""
    sc, topo, g, wl, q = _resolve(scenario, topology, graph, workload, qoe,
                                  seq_len)
    planner = DoraPlanner(g, topo, q,
                          partitioner_config=partitioner_config,
                          scheduler_config=scheduler_config,
                          adapter_config=adapter_config,
                          costs=costs)
    return planner, sc, wl


def plan(scenario: ScenarioRef, strategy: StrategyRef = "dora",
         **overrides) -> PlanReport:
    """Plan one scenario with any registered planner strategy.

    ``dora.plan("smart_home_2")`` runs Algorithm 1 end to end for the
    registered deployment; keyword overrides swap any ingredient
    (``workload=``, ``qoe=``, ``graph=``, ``topology=``, ``seq_len=``,
    ``partitioner_config=``, ``scheduler_config=``, ``costs=``).

    ``strategy=`` selects a different planner from the
    ``repro_torch.strategies`` registry (name or instance), e.g.
    ``dora.plan("smart_home_2", strategy="chain_split")``; planner
    configuration then goes through
    ``get_strategy(name, **params)`` rather than the DoraPlanner
    config overrides.
    """
    if strategy == "dora":
        planner, sc, wl = planner_for(scenario, **overrides)
        result = planner.plan(wl)
        return PlanReport(scenario=sc, topology=planner.topo,
                          graph=planner.graph, workload=wl, qoe=planner.qoe,
                          result=result)
    strat = get_strategy(strategy)
    bad = {k for k in ("partitioner_config", "scheduler_config",
                       "adapter_config") if overrides.get(k) is not None}
    if bad:
        raise ValueError(f"{sorted(bad)} only apply to the 'dora' strategy; "
                         f"configure {strat.name!r} via "
                         f"get_strategy(name, **params) and pass the instance")
    costs = overrides.pop("costs", None)
    for k in ("partitioner_config", "scheduler_config", "adapter_config"):
        overrides.pop(k, None)
    sc, topo, g, wl, q = _resolve(scenario,
                                  overrides.pop("topology", None),
                                  overrides.pop("graph", None),
                                  overrides.pop("workload", None),
                                  overrides.pop("qoe", None),
                                  overrides.pop("seq_len", None))
    if overrides:
        raise TypeError(f"unexpected overrides: {sorted(overrides)}")
    result = strat.plan(g, topo, q, wl, costs=costs)
    return PlanReport(scenario=sc, topology=topo, graph=g, workload=wl,
                      qoe=q, result=result, strategy=strat.name)


@dataclasses.dataclass
class StrategyOutcome:
    """One strategy's run inside a :class:`ComparisonReport`."""

    strategy: str
    result: Optional[PlanningResult] = None
    planning_s: float = 0.0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.result is not None

    @property
    def latency(self) -> float:
        return self.result.best.latency if self.ok else math.inf

    @property
    def energy(self) -> float:
        return self.result.best.energy if self.ok else math.inf


@dataclasses.dataclass
class ComparisonReport:
    """Several planner strategies on one scenario, side by side.

    Latency/energy are real-topology numbers (contention-aware
    strategies price contention themselves; oblivious ones are executed
    under fluid-fair sharing).  ``reference`` (normally ``"dora"``)
    anchors the speedup / energy-savings columns.
    """

    scenario: Scenario
    qoe: QoESpec
    reference: str
    outcomes: Dict[str, StrategyOutcome]

    def __getitem__(self, name: str) -> StrategyOutcome:
        return self.outcomes[name]

    @property
    def strategies(self) -> List[str]:
        return list(self.outcomes)

    def meets_qoe(self, name: str) -> bool:
        out = self.outcomes[name]
        return out.ok and self.qoe.satisfied(out.result.best)

    def speedup(self, name: str) -> float:
        """How many times faster the reference is than ``name``
        (>1 means the reference wins)."""
        ref = self.outcomes[self.reference]
        out = self.outcomes[name]
        if not (ref.ok and out.ok):
            return math.nan
        return out.latency / ref.latency

    def energy_savings(self, name: str) -> float:
        """Fraction of ``name``'s energy the reference saves (0.21 =
        21% less energy than that baseline)."""
        ref = self.outcomes[self.reference]
        out = self.outcomes[name]
        if not (ref.ok and out.ok) or out.energy <= 0.0:
            return math.nan
        return 1.0 - ref.energy / out.energy

    def best_baseline(self) -> Tuple[str, StrategyOutcome]:
        """Fastest successful non-reference strategy."""
        ok = {k: v for k, v in self.outcomes.items()
              if k != self.reference and v.ok}
        if not ok:
            raise RuntimeError("no baseline strategy produced a valid plan")
        name = min(ok, key=lambda k: ok[k].latency)
        return name, ok[name]

    def to_dict(self) -> Dict[str, object]:
        rows = {}
        for name, out in self.outcomes.items():
            rows[name] = {
                "ok": out.ok,
                "error": out.error,
                "latency_s": _json_num(out.latency),
                "energy_j": _json_num(out.energy),
                "meets_qoe": self.meets_qoe(name),
                "planning_s": _json_num(out.planning_s),
                "speedup_vs_reference": _json_num(self.speedup(name))
                    if out.ok else None,
                "reference_energy_savings": _json_num(self.energy_savings(name))
                    if out.ok else None,
                "best": _plan_dict(out.result.best) if out.ok else None,
            }
        return {
            "scenario": self.scenario.name,
            "mode": self.scenario.mode,
            "model": self.scenario.model_name,
            "reference": self.reference,
            "qoe": {"t_qoe_s": _json_num(self.qoe.t_qoe),
                    "e_qoe_j": _json_num(self.qoe.e_qoe),
                    "lam": _json_num(self.qoe.lam)},
            "strategies": rows,
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        """Serialize to strict JSON; optionally also write to ``path``."""
        text = json.dumps(self.to_dict(), indent=indent, allow_nan=False)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        return text

    def summary(self) -> str:
        headers = ("strategy", "lat (ms)", "energy (J)", "QoE", "plan (s)",
                   f"vs {self.reference}")
        rows: List[Tuple[str, ...]] = []
        for name, out in self.outcomes.items():
            if not out.ok:
                rows.append((name, "ERROR", out.error or "?", "-", "-", "-"))
                continue
            sp = self.speedup(name)
            sv = self.energy_savings(name)
            vs = ("(reference)" if name == self.reference else
                  f"{sp:.2f}x lat, {sv:+.0%} E")
            rows.append((name, f"{out.latency * 1e3:.1f}",
                         f"{out.energy:.1f}",
                         "MET" if self.meets_qoe(name) else "MISS",
                         f"{out.planning_s:.2f}", vs))
        widths = [max(len(h), *(len(r[i]) for r in rows))
                  for i, h in enumerate(headers)]
        lines = [f"strategy comparison — scenario {self.scenario.name} "
                 f"[{self.scenario.mode}] model={self.scenario.model_name}",
                 "  ".join(h.ljust(w) for h, w in zip(headers, widths)),
                 "  ".join("-" * w for w in widths)]
        for r in rows:
            lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
        return "\n".join(lines)


def compare(scenario: ScenarioRef,
            strategies: Sequence[StrategyRef] = DEFAULT_COMPARISON, *,
            costs: Optional[CostProvider] = None,
            topology: Optional[Topology] = None,
            graph: Optional[ModelGraph] = None,
            workload: Optional[Workload] = None,
            qoe: Optional[QoESpec] = None,
            seq_len: Optional[int] = None) -> ComparisonReport:
    """Run several planner strategies on one scenario and tabulate them.

    Strategies resolve through the ``repro_torch.strategies`` registry (names
    or instances); ``"dora"`` gets the benchmark-grade search
    (``top_k=10`` + microbatch sweep) so the comparison matches the
    Fig. 8/9 harnesses.  A strategy that fails (e.g. EdgeShard OOM)
    becomes an error row, not an exception — the failure is the finding.
    """
    if not strategies:
        raise ValueError("compare needs at least one strategy "
                         f"(e.g. {list(DEFAULT_COMPARISON)})")
    sc, topo, g, wl, q = _resolve(scenario, topology, graph, workload, qoe,
                                  seq_len)
    outcomes: Dict[str, StrategyOutcome] = {}
    for ref in strategies:
        strat = (get_strategy(ref, top_k=10, sweep_microbatch=True)
                 if ref == "dora" else get_strategy(ref))
        t0 = time.perf_counter()
        try:
            result = strat.plan(g, topo, q, wl, costs=costs)
            outcomes[strat.name] = StrategyOutcome(
                strategy=strat.name, result=result,
                planning_s=result.total_s)
        except Exception as e:  # noqa: BLE001 — the failure is the finding
            outcomes[strat.name] = StrategyOutcome(
                strategy=strat.name, planning_s=time.perf_counter() - t0,
                error=f"{type(e).__name__}: {e}")
    reference = "dora" if "dora" in outcomes else next(iter(outcomes))
    return ComparisonReport(scenario=sc, qoe=q, reference=reference,
                            outcomes=outcomes)


@dataclasses.dataclass
class ServeSession:
    """A planned deployment with its runtime adapter armed (§4.3).

    The session carries the *cumulative* runtime picture across events:

    * ``state`` — the merge of every ``DynamicsEvent`` so far (a
      bandwidth drop at t=10 stays in force when a compute-speed event
      arrives at t=20); every adapter reaction sees the merged state.
    * ``active`` — which devices of the original deployment topology
      are currently in the fleet; ``leave``/``join`` churn events
      shrink/grow it and force a full replan on the surviving fleet
      (``Topology.subset``), with the migration stall priced by the
      adapter's delta-switching model.
    * ``plans`` — the current candidate pool replanning draws from
      (the planner's candidates, refreshed on churn).

    ``current`` (and the plans in ``plans``) are indexed in the *active*
    fleet's device space; ``active[i]`` maps stage device ``i`` back to
    the original topology index.
    """

    report: PlanReport
    adapter: RuntimeAdapter
    current: ParallelismPlan
    state: RuntimeState = dataclasses.field(default_factory=RuntimeState)
    active: Tuple[int, ...] = ()
    plans: List[ParallelismPlan] = dataclasses.field(default_factory=list)
    #: the fleet (original ids) ``current`` is indexed in; equal to
    #: ``active`` except during degraded segments, where churn shrank
    #: the fleet but no plan could be built on the survivors
    plan_fleet: Tuple[int, ...] = ()
    #: True while the surviving fleet has no servable plan (e.g. churn
    #: disconnected the routed topology, or nothing QoE-feasible
    #: remains); cleared by the next successful churn replan (rejoin)
    degraded: bool = False
    # planner knobs carried across churn replans (report.topology is
    # already cost-calibrated, so churn planners must NOT re-apply a
    # CostProvider — only the search/scheduler configs carry over)
    partitioner_config: Optional[PartitionerConfig] = None
    scheduler_config: Optional[SchedulerConfig] = None
    #: churn replans warm-start from the surviving candidate pool
    #: (``DoraPlanner.replan``) instead of re-running the full DP; the
    #: fresh search still runs whenever no surviving candidate is
    #: QoE-feasible on the new fleet
    warm_replan: bool = True
    #: control-plane mechanism switches (priority preemption, battery
    #: SoC, streamed migration); ``None`` = everything off
    control: Optional[ControlConfig] = None

    def __post_init__(self) -> None:
        if not self.active:
            self.active = tuple(range(self.report.topology.n))
        if not self.plan_fleet:
            self.plan_fleet = self.active
        if not self.plans:
            self.plans = list(self.report.candidates)
        #: the session's reaction layer — every dynamics decision
        #: (state accumulation, replan/fallback, migration pricing)
        #: lives there; the methods below are thin adapters over it
        self.plane = ControlPlane(self, self.control)

    def _translate(self, state: RuntimeState) -> RuntimeState:
        """Original-index conditions → plan-fleet index space (adapter
        over :meth:`ControlPlane.translate`)."""
        return self.plane.translate(state)

    def on_dynamics(self, event: DynamicsEvent,
                    replan: bool = True) -> Tuple[ParallelismPlan, str, float]:
        """Feed one runtime event to the control plane; track the
        active plan.

        Returns (new plan, action taken, reaction seconds).  ``replan``
        permits full replanning on large shifts; small fluctuations are
        absorbed with network-only rescheduling either way.  Device
        ``leave``/``join`` churn always replans (the fleet changed).
        The event is merged into the session's cumulative ``state``, so
        successive partial events compound instead of overwriting each
        other.  (Thin adapter over :meth:`ControlPlane.on_dynamics` —
        the single reaction implementation.)
        """
        return self.plane.on_dynamics(event, replan=replan)

    def _on_churn(self, event: DynamicsEvent
                  ) -> Tuple[ParallelismPlan, str, float]:
        """Devices left/joined: replan from scratch on the new fleet
        (adapter over :meth:`ControlPlane.churn`)."""
        return self.plane.churn(event)

    @property
    def meets_qoe(self) -> bool:
        """Full QoE verdict for the active plan: latency target AND
        energy/memory budgets (``QoESpec.satisfied``). A degraded
        session (no servable plan for the surviving fleet) never
        meets QoE."""
        if self.degraded:
            return False
        return self.report.qoe.satisfied(self.current)


def serve(scenario: ScenarioRef, *, warm_replan: bool = True,
          control: Optional[ControlConfig] = None,
          **overrides) -> ServeSession:
    """Plan a scenario and arm the runtime adapter over its Pareto set.

    ``warm_replan=False`` forces churn events through the full fresh DP
    (the pre-warm-start behavior) — the planner benchmark uses it to
    price cold vs. warm replans.

    ``control=`` arms control-plane mechanisms
    (:class:`repro_torch.control.ControlConfig`): priority preemption,
    battery state of charge and DEFER-style streamed migration.  With
    the default ``None`` every mechanism is off and the session behaves
    exactly as before."""
    planner, sc, wl = planner_for(scenario, **overrides)
    result = planner.plan(wl)
    report = PlanReport(scenario=sc, topology=planner.topo,
                        graph=planner.graph, workload=wl, qoe=planner.qoe,
                        result=result)
    adapter = planner.make_adapter(result)
    if control is not None and control.streamed_migration:
        # the streamed-migration switch lives on the AdapterConfig so
        # it survives churn replans (the config object is carried over)
        adapter.config.streamed_migration = True
        adapter.config.stream_bw_fraction = control.stream_bw_fraction
    return ServeSession(report=report, adapter=adapter, current=result.best,
                        partitioner_config=planner.partitioner.config,
                        scheduler_config=planner.scheduler.config,
                        warm_replan=warm_replan, control=control)


def calibrate(scenario: Optional[ScenarioRef] = None, *, quick: bool = True,
              path: Optional[str] = None, cache=None):
    """Microbenchmark this host and return a ``ProfiledCosts`` provider.

    The only facade verb that touches a device: it runs the
    :mod:`repro_torch.calibrate` measurement suite (matmul peak, memory
    bandwidth, timed zoo steps, contended stage rate) on the local
    backend and converts the measured-vs-analytic gaps into cost
    factors.

    Without ``scenario`` this returns the host fleet's own per-device
    calibration (devices ``host0..hostN``) — what the fidelity bench
    plans with.  With a ``scenario``, the host factors are applied as a
    *global* correction (``default_compute`` / ``default_bandwidth``)
    so they reach the scenario's differently-named devices::

        costs = dora.calibrate("smart_home_2", path="calibration/home.json")
        report = dora.plan("smart_home_2", costs=costs)
        # or later, from the committed artifact:
        report = dora.plan("smart_home_2", costs="profiled:calibration/home.json")

    ``path`` also writes the artifact as JSON; ``cache`` is a
    :class:`repro_torch.calibrate.MeasurementCache` (defaults to the on-disk
    cache, pass ``MeasurementCache(path=None)`` to force fresh
    measurements).
    """
    from .calibrate.host import calibrate_host
    from .core.profiler import ProfiledCosts
    host = calibrate_host(cache, quick=quick,
                          path=None if scenario is not None else path)
    if scenario is None:
        return host
    sc = get_scenario(scenario)
    cf = list(host.compute_factor.values())
    bf = list(host.bandwidth_factor.values())
    out = ProfiledCosts(
        default_compute=sum(cf) / len(cf) if cf else 1.0,
        default_bandwidth=sum(bf) / len(bf) if bf else 1.0,
        name=f"profiled-host/{sc.name}",
        provenance={**dict(host.provenance),
                    "applied_as": "global host-measured correction "
                                  f"for scenario {sc.name}"})
    if path is not None:
        out.to_json(path)
    return out


# -- multi-tenant fleets --------------------------------------------------------
def plan_fleet(fleet, *, topology=None,
               strategy="dora",
               fleet_config=None,
               partitioner_config: Optional[PartitionerConfig] = None,
               scheduler_config: Optional[SchedulerConfig] = None,
               adapter_config: Optional[AdapterConfig] = None,
               costs: Optional[CostProvider] = None):
    """Co-plan several workloads on one shared fleet.

    ``fleet`` is a registered fleet-scenario name (``python -m
    repro_torch.scenarios --list --fleet``), a
    :class:`~repro_torch.fleet.FleetScenario`, or a plain list of tenant
    scenario refs (then ``topology`` — or the first tenant's — is the
    shared fleet).  Devices are assigned *exclusively* per tenant and
    shared links are priced at their fluid-fair cross-tenant share; the
    assignment search keeps every tenant QoE-feasible first, then
    minimizes total energy (see :class:`repro_torch.fleet.FleetPlanner`).
    ``strategy`` is one name for all tenants or a ``{tenant: name}``
    dict.  Returns a :class:`repro_torch.fleet.FleetPlan`.
    """
    from .fleet import FleetPlanner, resolve_fleet
    fs = resolve_fleet(fleet, topology=topology)
    planner = FleetPlanner(fs.build_topology(), fs.tenants, name=fs.name,
                           strategy=strategy, config=fleet_config,
                           partitioner_config=partitioner_config,
                           scheduler_config=scheduler_config,
                           adapter_config=adapter_config, costs=costs)
    return planner.plan()


def serve_fleet(fleet, *, topology=None, strategy="dora",
                fleet_config=None,
                partitioner_config: Optional[PartitionerConfig] = None,
                scheduler_config: Optional[SchedulerConfig] = None,
                adapter_config: Optional[AdapterConfig] = None,
                costs: Optional[CostProvider] = None):
    """Co-plan a fleet and arm every tenant's runtime adapter plus the
    cross-tenant rebalancer.  Returns a
    :class:`repro_torch.fleet.FleetSession` whose ``on_dynamics`` routes
    events to the owning tenants and moves devices between tenants on
    churn or QoE-breaking load shifts."""
    from .fleet import FleetPlanner, FleetSession, resolve_fleet
    fs = resolve_fleet(fleet, topology=topology)
    planner = FleetPlanner(fs.build_topology(), fs.tenants, name=fs.name,
                           strategy=strategy, config=fleet_config,
                           partitioner_config=partitioner_config,
                           scheduler_config=scheduler_config,
                           adapter_config=adapter_config, costs=costs)
    return FleetSession(planner, planner.plan(), scenario=fs)


@dataclasses.dataclass(frozen=True)
class SimulationStep:
    t: float
    label: str
    action: str                 # "reschedule" | "replan"
    react_seconds: float
    latency: float
    qoe_ok: bool


@dataclasses.dataclass
class SimulationTrace:
    report: PlanReport
    steps: List[SimulationStep]

    @property
    def qoe_violations(self) -> int:
        return sum(1 for s in self.steps if not s.qoe_ok)

    def to_dict(self) -> Dict[str, object]:
        return {
            "scenario": self.report.scenario.name,
            "baseline_latency_s": _json_num(self.report.latency),
            "qoe_violations": self.qoe_violations,
            "steps": [{
                "t": s.t, "label": s.label, "action": s.action,
                "react_s": _json_num(s.react_seconds),
                "latency_s": _json_num(s.latency), "qoe_ok": s.qoe_ok,
            } for s in self.steps],
        }

    def summary(self) -> str:
        lines = [f"baseline latency {self.report.latency * 1e3:.1f} ms "
                 f"(QoE target {self.report.qoe.t_qoe:g}s)"]
        for s in self.steps:
            lines.append(
                f"t={s.t:6.1f}s  {s.label:52s} -> {s.action:10s} "
                f"({s.react_seconds * 1e3:.0f} ms) latency "
                f"{s.latency * 1e3:8.1f} ms "
                f"{'[QoE OK]' if s.qoe_ok else '[QoE MISS]'}")
        lines.append(f"{len(self.steps)} events, "
                     f"{self.qoe_violations} QoE violations")
        return "\n".join(lines)


def simulate(scenario: ScenarioRef,
             events: Optional[Sequence[TimelineItem]] = None,
             session: Optional[ServeSession] = None,
             copy: bool = False,
             mode: str = "events",
             **overrides) -> Union[SimulationTrace, "ServingTrace"]:
    """Replay a dynamics timeline through the runtime adapter.

    ``events`` defaults to the scenario's registered timeline; each item
    is a ``DynamicsEvent`` or a ``(label, event)`` pair.  Every event's
    adapter reaction (reschedule vs replan, reaction time, post-event
    latency) is recorded in the returned trace.  Pass an existing
    ``session`` (from ``dora.serve`` of the *same* scenario) to reuse
    its plan instead of re-running the planner.

    ``mode="events"`` (default) replays the timeline event-by-event and
    returns a :class:`SimulationTrace`.  ``mode="requests"`` runs the
    request-level serving simulator (``repro_torch.sim.serving``): open-loop
    arrivals at the scenario's registered request rate queue through
    the active plan's pipeline while the timeline (bandwidth/compute
    shifts AND device join/leave churn) plays out; returns a
    :class:`repro_torch.sim.serving.ServingTrace` with p50/p95/p99 latency,
    SLO attainment, per-device energy (idle draw included) and every
    adapter action.  Extra knobs for that mode: ``load=`` (a
    ``ServingLoad``), ``strategy=`` (simulate a non-adaptive baseline
    strategy instead of dora's adapter).

    ``mode="fleet"`` runs the *multi-tenant* serving simulator
    (``repro_torch.sim.fleet``): ``scenario`` is then a fleet-scenario name /
    :class:`repro_torch.fleet.FleetScenario` / tenant list, every tenant gets
    its own concurrent request stream on its exclusive device
    allotment, and the fleet timeline flows through the cross-tenant
    rebalancer; returns a :class:`repro_torch.sim.fleet.FleetTrace`.  Extra
    knobs: ``loads=`` ({tenant: ServingLoad}), ``span_s=``, ``seed=``;
    ``session=`` takes a :class:`repro_torch.fleet.FleetSession` from
    ``dora.serve_fleet``.

    **Mutation contract:** replaying events *advances the session* —
    ``session.current`` tracks the adapter's latest plan (after churn,
    re-indexed to the surviving fleet with ``session.active`` mapping
    back to original device ids) and the adapter's internal Pareto set
    is re-evaluated under the final event's conditions, exactly as a
    live deployment would be left.  Pass ``copy=True`` to deep-copy the
    session (adapter state included) first and replay against the copy,
    leaving the caller's session untouched; the returned trace then
    references the copy's report.
    """
    if mode == "requests":
        from .sim.serving import simulate_requests
        if copy and session is not None:
            session = _copy.deepcopy(session)
        return simulate_requests(scenario, events=events, session=session,
                                 **overrides)
    if mode == "fleet":
        from .sim.fleet import simulate_fleet
        if copy and session is not None:
            session = _copy.deepcopy(session)
        return simulate_fleet(scenario, events=events, session=session,
                              **overrides)
    if mode != "events":
        raise ValueError(f"unknown mode {mode!r}: expected 'events', "
                         f"'requests' or 'fleet'")
    if session is None:
        session = serve(scenario, **overrides)
    else:
        want = get_scenario(scenario).name
        have = session.report.scenario.name
        if want != have:
            raise ValueError(f"session was served for scenario {have!r}, "
                             f"not {want!r}")
        if overrides:
            raise ValueError("overrides are ignored when reusing a session; "
                             "pass them to dora.serve instead")
        if copy:
            session = _copy.deepcopy(session)
    from .core.events import normalize_timeline
    timeline = normalize_timeline(
        events if events is not None else session.report.scenario.timeline)
    steps: List[SimulationStep] = []
    for label, ev in timeline:
        new, action, react = session.on_dynamics(ev)
        steps.append(SimulationStep(t=ev.t, label=label, action=action,
                                    react_seconds=react, latency=new.latency,
                                    qoe_ok=session.meets_qoe))
    return SimulationTrace(report=session.report, steps=steps)


#: moved internals kept importable with a DeprecationWarning (the
#: reaction layer now lives in ``repro_torch.control``)
_MOVED = {
    "_remap_plan": "_remap_plan",
}


def __getattr__(name: str):
    target = _MOVED.get(name)
    if target is not None:
        warnings.warn(
            f"repro_torch.dora.{name} moved to repro_torch.control.plane.{target}; "
            f"import it from there",
            DeprecationWarning, stacklevel=2)
        from .control import plane as _plane
        return getattr(_plane, target)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PlanReport", "ServeSession", "SimulationStep", "SimulationTrace",
    "StrategyOutcome", "ComparisonReport", "DEFAULT_COMPARISON",
    "ControlConfig", "RuntimeState", "calibrate", "plan", "planner_for",
    "serve", "simulate", "compare", "plan_fleet", "serve_fleet",
]
