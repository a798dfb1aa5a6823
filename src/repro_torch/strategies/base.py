# A copy of src/repro/strategies/base.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""The ``PlannerStrategy`` protocol and its decorator-based registry.

Dora's headline numbers are *comparative* — they only mean something
against other planners.  This module makes every planner (Dora itself,
the paper's baselines, new split heuristics) a first-class, swappable
citizen behind one protocol::

    class PlannerStrategy(Protocol):
        name: str
        contention_aware: bool
        def plan(graph, topology, qoe, workload, costs=None) -> PlanningResult

``contention_aware`` declares whether the strategy prices its plans on
the real shared medium itself (Dora's Phase 2) — oblivious strategies
must return plans already *executed* under fluid-fair contention, which
is what a contention-oblivious plan actually suffers (Fig. 2); the
``fair_executed`` helper does exactly that.

Strategies register with the :func:`register_strategy` class decorator
and are resolved by name through :func:`get_strategy`, which also
forwards constructor keywords (``get_strategy("brute_force",
shortlist=150)``).  Consumers: ``dora.plan(scenario, strategy=...)``,
``dora.compare``, ``sim.runner.compare_planners``, the fig-benchmarks
and ``python -m repro_torch.scenarios --strategy/--compare``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Protocol, Sequence, Type, Union, \
    runtime_checkable

from ..core.adapter import pareto_filter
from ..core.cost_model import CostProvider, Workload
from ..core.device import Topology
from ..core.planner import PlanningResult
from ..core.planning_graph import ModelGraph
from ..core.plans import ParallelismPlan
from ..core.qoe import QoESpec
from ..core.scheduler import NetworkScheduler


class StrategyError(RuntimeError):
    """Strategy could not produce a valid plan (e.g. EdgeShard OOM)."""


@runtime_checkable
class PlannerStrategy(Protocol):
    """One hybrid-parallelism planner behind a uniform entry point."""

    name: str
    contention_aware: bool

    def plan(self, graph: ModelGraph, topology: Topology, qoe: QoESpec,
             workload: Workload,
             costs: Optional[CostProvider] = None) -> PlanningResult:
        """Plan ``graph`` on ``topology`` for ``workload`` under ``qoe``.

        Returned latencies/energies must be real-topology numbers:
        contention-aware strategies price contention themselves,
        oblivious ones report what their plan suffers under fluid-fair
        sharing (``fair_executed``). Raises :class:`StrategyError` when
        no valid plan exists."""
        ...


_REGISTRY: Dict[str, Type] = {}

StrategyRef = Union[str, PlannerStrategy]


def register_strategy(cls: Type) -> Type:
    """Class decorator: register ``cls`` under its ``name`` attribute."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError(f"{cls!r} needs a non-empty string `name` attribute")
    if name in _REGISTRY:
        raise ValueError(f"planner strategy {name!r} already registered")
    _REGISTRY[name] = cls
    return cls


def list_strategies() -> List[str]:
    """Names of all registered strategies, sorted."""
    return sorted(_REGISTRY)


def get_strategy(ref: StrategyRef, **params) -> PlannerStrategy:
    """Resolve a strategy name to a fresh instance (or pass through an
    already-constructed strategy object).  ``params`` are forwarded to
    the strategy constructor when resolving by name."""
    if isinstance(ref, str):
        try:
            cls = _REGISTRY[ref]
        except KeyError:
            known = ", ".join(sorted(_REGISTRY))
            raise ValueError(f"unknown planner strategy {ref!r}; "
                             f"registered: {known}") from None
        return cls(**params)
    if params:
        raise ValueError("constructor params only apply when resolving a "
                         "strategy by name")
    return ref


# ----------------------------------------------------------------------------
# shared helpers for strategy implementations
# ----------------------------------------------------------------------------
def fair_executed(plan: ParallelismPlan, topo: Topology,
                  qoe: QoESpec) -> ParallelismPlan:
    """Price one plan under real fluid-shared contention (what a
    contention-oblivious plan actually experiences, Fig. 2)."""
    return NetworkScheduler(topo, qoe).evaluate_fair(plan)


def as_result(plans: Sequence[ParallelismPlan], phase1_s: float,
              phase2_s: float) -> PlanningResult:
    """Wrap already-priced plans into a :class:`PlanningResult` (ranked
    best-first by objective, Pareto frontier attached)."""
    if not plans:
        raise StrategyError("strategy produced no plan")
    ranked = sorted(plans, key=lambda p: p.objective)
    return PlanningResult(best=ranked[0], candidates=ranked,
                          pareto=pareto_filter(ranked),
                          phase1_s=phase1_s, phase2_s=phase2_s)


class _Stopwatch:
    """Tiny helper: ``lap()`` returns seconds since the previous lap."""

    def __init__(self):
        self._t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self._t = now - self._t, now
        return dt
