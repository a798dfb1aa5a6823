# A copy of src/repro/fleet/session.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's fleet plans must match the reference's to the last bit.
"""The armed multi-tenant runtime: per-tenant adapters + rebalancing.

A :class:`FleetSession` is to a fleet what
:class:`~repro_torch.dora.ServeSession` is to one workload.  It keeps one
ServeSession per tenant (each with its runtime adapter armed over the
tenant's candidate pool) plus the *fleet-level* cumulative picture:

* Non-churn dynamics events are translated into each tenant's device
  space and routed to its adapter — a compute-speed drop on a device
  only stirs the tenant that owns it; a shared-link bandwidth shift
  reaches every tenant on the medium.
* Device ``leave``/``join`` churn — and load shifts that leave a tenant
  QoE-infeasible — trigger a **rebalance**: the
  :class:`~repro_torch.fleet.planner.FleetPlanner` search re-runs on the
  surviving fleet under the accumulated conditions, warm-starting every
  dora tenant from its surviving candidate pool
  (:meth:`DoraPlanner.replan`) and always pricing the incumbent
  assignment so devices only move when moving wins.  Each re-assigned
  tenant's migration stall is priced by the adapter's delta-switching
  model against its previous plan re-indexed into the new allotment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..control.plane import FleetControlPlane, _remap_plan
from ..core.adapter import DynamicsEvent, RuntimeAdapter, RuntimeState, \
    cold_load_stall
from ..core.scheduler import NetworkScheduler
from ..dora import ServeSession
from .planner import FleetPlan, FleetPlanner, TenantPlan, _translate


def _orig_placement(plan, tp: TenantPlan) -> tuple:
    """A tenant-local plan's placement signature in *fleet* device space
    (which model nodes sit on which physical devices)."""
    inv = {loc: orig for orig, loc in tp.mapping.items()}
    return tuple((tuple(s.node_ids), tuple(sorted(inv[d] for d in s.devices)))
                 for s in plan.stages)


@dataclasses.dataclass(frozen=True)
class TenantAction:
    """What the fleet runtime did about one event, for one tenant."""

    tenant: str
    action: str            # "reschedule" | "replan" | "rebalance"
    react_s: float
    stall_s: float
    latency_after: float
    allotment: Tuple[int, ...]


class FleetSession:
    """N tenant sessions + the rebalancer that moves devices between
    them.  ``sessions[name].current`` is tenant-local; map back to
    fleet ids via ``plan.tenants[name].allotment``."""

    def __init__(self, planner: FleetPlanner, plan: FleetPlan,
                 scenario=None):
        self.planner = planner
        self.plan = plan
        self.scenario = scenario        # FleetScenario (or None for ad-hoc)
        self.state = RuntimeState()     # fleet-space cumulative conditions
        self.active: Tuple[int, ...] = tuple(range(planner.topo.n))
        self.rebalances = 0
        self.sessions: Dict[str, ServeSession] = {}
        for name, tp in plan.tenants.items():
            self.sessions[name] = self._arm_tenant(tp)
        #: the fleet's reaction layer (event routing + rebalancing);
        #: ``on_dynamics`` below is a thin adapter over it
        self.plane = FleetControlPlane(self)

    # -- wiring -------------------------------------------------------------------
    def _arm_tenant(self, tp: TenantPlan,
                    state: Optional[RuntimeState] = None) -> ServeSession:
        report = tp.report
        scheduler = NetworkScheduler(report.topology, report.qoe,
                                     self.planner.scheduler_config)
        adapter = RuntimeAdapter(report.candidates, report.topology,
                                 report.qoe, scheduler,
                                 self.planner.adapter_config)
        current = report.best
        local = state or RuntimeState()
        if local.compute_speed or local.bandwidth_scale:
            current = scheduler.refine(
                current, compute_speed=dict(local.compute_speed),
                bandwidth_scale=dict(local.bandwidth_scale))
        return ServeSession(report=report, adapter=adapter, current=current,
                            state=local,
                            partitioner_config=self.planner.partitioner_config,
                            scheduler_config=self.planner.scheduler_config)

    def _local_state(self, tp: TenantPlan,
                     merged: RuntimeState) -> RuntimeState:
        kw = _translate(merged, tp.mapping, tp.report.topology)
        # bandwidth entries are retained wholesale (resource ids are
        # fleet-global): a link outside the tenant's *current*
        # sub-topology doesn't price its plan today, but the tenant may
        # be rebalanced onto it later and must remember the shift —
        # dropping entries here made tenant state diverge from the
        # fleet's cumulative RuntimeState
        return RuntimeState(compute_speed=kw["compute_speed"],
                            bandwidth_scale=dict(merged.bandwidth_scale))

    def _local_event(self, tp: TenantPlan,
                     event: DynamicsEvent) -> Optional[DynamicsEvent]:
        """``event`` in the tenant's device space, or ``None`` when it
        doesn't touch this tenant's devices or links at all."""
        speed = {tp.mapping[d]: v for d, v in event.compute_speed.items()
                 if d in tp.mapping}
        bw = {r: v for r, v in event.bandwidth_scale.items()
              if r in tp.report.topology.resources}
        if not speed and not bw:
            return None
        return DynamicsEvent(t=event.t, compute_speed=speed,
                             bandwidth_scale=bw)

    # -- properties ---------------------------------------------------------------
    @property
    def assignments(self) -> Dict[str, Tuple[int, ...]]:
        return self.plan.assignments

    @property
    def meets_qoe(self) -> bool:
        return all(s.meets_qoe for s in self.sessions.values())

    def tenant(self, name: str) -> ServeSession:
        return self.sessions[name]

    # -- dynamics -----------------------------------------------------------------
    def on_dynamics(self, event: DynamicsEvent) -> List[TenantAction]:
        """Feed one fleet-space runtime event to every affected tenant.

        Churn always rebalances; condition shifts route to the owning
        tenants' adapters, then trigger a rebalance if some tenant is
        left QoE-infeasible (and ``FleetConfig.rebalance_on_load``).
        Returns the actions taken, one per affected tenant.  (Thin
        adapter over :meth:`FleetControlPlane.on_dynamics` — the single
        reaction implementation.)
        """
        return self.plane.on_dynamics(event)

    def _rebalance(self, event: Optional[DynamicsEvent]
                   ) -> List[TenantAction]:
        """Re-run the assignment search on the surviving fleet and move
        devices between tenants (adapter over
        :meth:`FleetControlPlane.rebalance`)."""
        return self.plane.rebalance(event)

    def _migration_stall(self, old_current, old_tp: TenantPlan,
                         new_tp: TenantPlan, sess: ServeSession) -> float:
        """Delta-switching stall of moving one tenant between
        allotments: its old plan re-indexed into the new device space
        prices the layers already resident."""
        trans = {old_tp.mapping[orig]: new_tp.mapping[orig]
                 for orig in old_tp.allotment if orig in new_tp.mapping}
        proxy = _remap_plan(old_current, trans)
        new = sess.current
        if proxy is not None:
            return sess.adapter.switch_cost(proxy, new)
        return cold_load_stall(new, new_tp.report.topology,
                               sess.adapter.config)
