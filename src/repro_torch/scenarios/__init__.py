# A copy of src/repro/scenarios/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port must plan the reference's deployments, field for field.
"""Named end-to-end deployment scenarios for Dora.

Dora's headline claim is breadth across *deployments* — smart homes,
traffic analytics, small edge clusters — under multi-dimensional QoE.
This package makes that breadth the organizing axis of the codebase: a
:class:`Scenario` bundles everything Algorithm 1 needs to plan one
deployment end to end —

* a device fleet + network substrate (``core.device.Topology``),
* a model planning graph (``core.planning_graph.ModelGraph``),
* a workload (``core.cost_model.Workload``: training vs serving,
  batch/microbatch geometry),
* QoE targets (``core.qoe.QoESpec``: latency target, energy budget, λ),
* optionally a runtime-dynamics timeline (``core.adapter.DynamicsEvent``
  sequence) describing how conditions evolve mid-run.

Scenarios live in a process-global registry keyed by name.  The four
Table-3 settings of the paper are registered out of the box alongside
new deployments (retail analytics, hospital ward, vehicle platoon,
battery-degraded smart home, TPU-pod planning); adding another is one
:class:`Scenario` dataclass + :func:`register` call — see
``docs/ARCHITECTURE.md`` ("How to add a scenario").

Consumers:

* ``repro_torch.dora`` — the facade: ``dora.plan("hospital_ward")`` etc.;
* ``python -m repro_torch.scenarios --list/--run`` — the sweep CLI;
* ``repro_torch.sim.runner`` and the ``benchmarks/`` harnesses — resolve
  (setting, model) pairs through this registry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from ..core.adapter import DynamicsEvent
from ..core.cost_model import Workload
from ..core.device import Topology
from ..core.graph_builders import paper_model
from ..core.planning_graph import ModelGraph
from ..core.qoe import QoESpec

# A model reference is either a paper-model name ("qwen3-0.6b") or a
# builder taking the effective sequence length.
ModelRef = Union[str, Callable[[int], ModelGraph]]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named end-to-end deployment: fleet + model + workload + QoE."""

    name: str
    description: str
    topology: Callable[[], Topology]
    model: ModelRef
    workload: Workload
    qoe: QoESpec
    seq_len: int = 512
    tags: Tuple[str, ...] = ()
    # (label, event) pairs of runtime dynamics this deployment typically
    # experiences; ``dora.simulate`` replays them by default.
    timeline: Tuple[Tuple[str, DynamicsEvent], ...] = ()
    # mean open-loop request rate (requests/sec) this deployment serves;
    # drives the request-level simulator (``dora.simulate`` with
    # ``mode="requests"``).  For training deployments one "request" is
    # one iteration.  ``None`` → half the plan's service capacity.
    request_rate: Optional[float] = None
    # arrival process from the serving kernel's zoo
    # (``repro_torch.core.events``: DiurnalArrivals / MMPPArrivals /
    # FlashCrowdArrivals / TraceArrivals), modulating ``request_rate``;
    # ``None`` → homogeneous Poisson.
    arrival: Optional[object] = None
    # multi-class SLO tiers (``repro_torch.core.events.RequestClass`` tuple,
    # e.g. interactive vs. batch); empty → one implicit class at the
    # load's SLO.
    request_classes: Tuple[object, ...] = ()

    @property
    def mode(self) -> str:
        """``"train"`` or ``"serve"`` (from the workload)."""
        return "train" if self.workload.training else "serve"

    @property
    def model_name(self) -> str:
        if isinstance(self.model, str):
            return self.model
        return getattr(self.model, "__name__", "custom")

    def build_topology(self) -> Topology:
        """A **fresh** ``Topology`` on every call — never memoized.

        ``Topology`` carries mutable post-construction state (route /
        bandwidth memo caches, calibrated link rates), and consumers
        mutate their copy freely: ``FleetPlanner`` calibrates it,
        adapter sessions scale link capacities as dynamics land.
        Memoizing here would alias that state across sessions — two
        concurrent ``dora.serve`` sessions would see each other's
        bandwidth dips.  Topology factories must therefore rebuild from
        scratch (all catalog + generated factories do); the contract is
        locked by ``test_build_topology_returns_fresh_copies``.
        """
        return self.topology()

    def build_graph(self, seq_len: Optional[int] = None) -> ModelGraph:
        """Planning graph at the scenario's effective sequence length.

        Serving plans per generated token, so the planning graph is built
        at seq_len=1 unless explicitly overridden (matching the paper's
        per-token serving latency measurements).
        """
        if seq_len is None:
            seq_len = self.seq_len if self.workload.training else 1
        if isinstance(self.model, str):
            return paper_model(self.model, seq_len=seq_len)
        return self.model(seq_len)

    def summary_row(self) -> Tuple[str, str, str, str, str, str]:
        topo = self.build_topology()
        qoe = (f"{self.qoe.t_qoe:g}s" if self.qoe.t_qoe != float("inf")
               else "-")
        return (self.name, self.mode, self.model_name, str(topo.n), qoe,
                self.description)


# -- registry ------------------------------------------------------------------
_REGISTRY: Dict[str, Scenario] = {}

#: The paper's Table-3 settings, in paper order (used by benchmarks).
PAPER_SETTINGS: Tuple[str, ...] = (
    "smart_home_1", "smart_home_2", "traffic_monitor", "edge_cluster")


def register(scenario: Scenario, overwrite: bool = False) -> Scenario:
    """Add a scenario to the global registry (returns it for chaining)."""
    if scenario.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(ref: Union[str, Scenario]) -> Scenario:
    """Resolve a name (or pass through an ad-hoc Scenario object)."""
    if isinstance(ref, Scenario):
        return ref
    try:
        return _REGISTRY[ref]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {ref!r}; known: {known}") from None


def list_scenarios(tag: Optional[str] = None) -> List[str]:
    """Registered scenario names (optionally filtered by tag), sorted."""
    names = [n for n, s in _REGISTRY.items() if tag is None or tag in s.tags]
    return sorted(names)


def iter_scenarios(tag: Optional[str] = None) -> Iterable[Scenario]:
    for name in list_scenarios(tag):
        yield _REGISTRY[name]


# Populate the registry with the built-in catalogue on import.  The
# catalogue pulls in ``generate`` (the seeded scenario generator) for
# its generated-family representatives, so ``repro_torch.scenarios.generate``
# is always importable once the package is.
from . import catalog  # noqa: E402,F401  (registration side effects)
from . import generate  # noqa: E402,F401  (generator families)

__all__ = [
    "Scenario", "ModelRef", "PAPER_SETTINGS", "register", "get_scenario",
    "list_scenarios", "iter_scenarios", "catalog", "generate",
]
