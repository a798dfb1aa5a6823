# A copy of src/repro/fleet/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's fleet plans must match the reference's to the last bit.
"""``repro_torch.fleet`` — multi-tenant co-planning on one shared device fleet.

The single-tenant stack assumes one workload owns the whole
:class:`~repro_torch.core.device.Topology`.  Real edge deployments run
*several* models at once — a smart home serves a voice assistant while a
vision monitor watches the door; a roadside unit runs a detector and a
tracker.  This package plans N workloads ("tenants") jointly on one
shared fleet under a simple, enforceable contract:

* **Devices are exclusive** — the fleet planner partitions the device
  set among tenants; a tenant's pipeline only ever places layers on its
  own allotment, so compute never time-shares (and the serving
  simulator asserts no device is oversubscribed).
* **Links are shared** — a shared medium (WiFi) carries every tenant's
  transfers; each tenant plans against its fluid-fair share of the
  capacity (``Topology.scale_resources``), the same fluid model the
  Phase-2 scheduler uses for unscheduled contention.

Three layers mirror the single-tenant stack:

* :class:`~repro_torch.fleet.planner.FleetPlanner` — searches device
  assignments (cheap proxy scoring over every feasible partition, full
  per-tenant planning for the best few) for a joint objective: all
  tenants QoE-feasible first, then minimum total energy, then maximum
  latency headroom.
* :class:`~repro_torch.fleet.session.FleetSession` — the armed runtime: it
  routes dynamics events into each tenant's adapter and *rebalances
  devices between tenants* on fleet churn or when a load shift leaves a
  tenant QoE-infeasible (warm-starting every tenant replan from its
  surviving candidate pool, §4.3-style).
* :func:`repro_torch.sim.fleet.simulate_fleet` — concurrent per-tenant
  request streams against the composed plans with per-tenant
  p50/p95/p99, SLO attainment and per-device energy attribution.

Reachable from the facade as ``dora.plan_fleet(...)``,
``dora.serve_fleet(...)`` and ``dora.simulate(..., mode="fleet")``; the
multi-tenant deployments below (:mod:`repro_torch.fleet.catalog`) live in
their own registry, listed via ``python -m repro_torch.scenarios --list
--fleet``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

from ..core.adapter import DynamicsEvent
from ..core.device import Topology
from ..scenarios import Scenario, get_scenario


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """N tenant workloads co-deployed on one shared fleet.

    ``tenants`` are plain :class:`~repro_torch.scenarios.Scenario` objects —
    their model/workload/QoE/request-rate describe the tenant; their
    ``topology`` is *ignored* in favor of the fleet's shared one (by
    convention the catalog points both at the same builder, so planning
    a tenant standalone reproduces the "independent planning on the
    full fleet" baseline).  ``timeline`` events are in fleet device
    space and hit every tenant they touch.
    """

    name: str
    description: str
    topology: Callable[[], Topology]
    tenants: Tuple[Scenario, ...]
    timeline: Tuple[Tuple[str, DynamicsEvent], ...] = ()
    tags: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.tenants:
            raise ValueError("a fleet needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")

    def build_topology(self) -> Topology:
        return self.topology()

    def tenant(self, name: str) -> Scenario:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(f"fleet {self.name!r} has no tenant {name!r}; "
                       f"tenants: {[t.name for t in self.tenants]}")

    def summary_row(self) -> Tuple[str, str, str, str]:
        topo = self.build_topology()
        return (self.name, str(len(self.tenants)), str(topo.n),
                self.description)


# -- registry ------------------------------------------------------------------
_FLEETS: Dict[str, FleetScenario] = {}


def register_fleet(fleet: FleetScenario,
                   overwrite: bool = False) -> FleetScenario:
    if fleet.name in _FLEETS and not overwrite:
        raise ValueError(f"fleet scenario {fleet.name!r} already registered")
    _FLEETS[fleet.name] = fleet
    return fleet


def list_fleets(tag: Optional[str] = None) -> List[str]:
    return sorted(n for n, f in _FLEETS.items()
                  if tag is None or tag in f.tags)


def iter_fleets(tag: Optional[str] = None) -> Iterable[FleetScenario]:
    for name in list_fleets(tag):
        yield _FLEETS[name]


FleetRef = Union[str, FleetScenario, Sequence[Union[str, Scenario]]]


def resolve_fleet(ref: FleetRef,
                  topology: Optional[Union[Topology,
                                           Callable[[], Topology]]] = None
                  ) -> FleetScenario:
    """A :class:`FleetScenario` from a registry name, a ready object, or
    an ad-hoc list of tenant scenario refs.  ``topology`` overrides the
    shared fleet in every case (for ad-hoc lists the default is the
    first tenant's); it is never silently dropped."""
    topo_fn: Optional[Callable[[], Topology]] = None
    if topology is not None:
        topo_fn = ((lambda t=topology: t) if isinstance(topology, Topology)
                   else topology)
    if isinstance(ref, (FleetScenario, str)):
        if isinstance(ref, str):
            try:
                ref = _FLEETS[ref]
            except KeyError:
                known = ", ".join(sorted(_FLEETS))
                raise KeyError(f"unknown fleet scenario {ref!r}; "
                               f"known: {known}") from None
        if topo_fn is not None:
            ref = dataclasses.replace(ref, topology=topo_fn)
        return ref
    tenants = tuple(get_scenario(t) for t in ref)
    if not tenants:
        raise ValueError("an ad-hoc fleet needs at least one tenant")
    return FleetScenario(
        name="+".join(t.name for t in tenants),
        description="ad-hoc fleet of "
                    + ", ".join(t.name for t in tenants),
        topology=topo_fn or tenants[0].topology, tenants=tenants)


from .planner import FleetConfig, FleetPlan, FleetPlanner, TenantPlan, \
    plan_independent  # noqa: E402
from .session import FleetSession, TenantAction  # noqa: E402

# Populate the fleet registry with the built-in catalogue on import.
from . import catalog  # noqa: E402,F401  (registration side effects)

__all__ = [
    "FleetScenario", "FleetRef", "register_fleet", "list_fleets",
    "iter_fleets", "resolve_fleet",
    "FleetConfig", "FleetPlan", "FleetPlanner", "TenantPlan",
    "plan_independent", "FleetSession", "TenantAction", "catalog",
]
