# A copy of src/repro/sim/fleet.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""Multi-tenant request-level serving: N concurrent streams, one fleet.

Extends :mod:`repro_torch.sim.serving` to a co-planned fleet: every tenant
gets its own open-loop arrival stream (at its registered
``request_rate``, through its registered arrival process / request
classes) served by its own pipeline on its *exclusive* device
allotment, while the fleet timeline (bandwidth/compute shifts and
device churn) plays out through the :class:`~repro_torch.fleet.FleetSession`
— rebalances move devices between tenants mid-run and bill each moved
tenant's migration stall against its own admissions.

All bookkeeping delegates to the shared serving kernel
(:mod:`repro_torch.core.events`): one :class:`~repro_torch.core.events.Stream` per
tenant replays the fleet timeline, vectorizing each inter-event
segment with the same Lindley recurrence as the single-tenant path.
Fleet-level attribution:

* **Idle draw** is billed once per fleet device over its *presence
  interval* and prorated across the tenants that owned the device, by
  ownership interval (:class:`~repro_torch.core.events.OwnershipTracker`) —
  a device that changed hands mid-run bills each owner for its own
  span; spans owned by no tenant land in the fleet-wide totals only.
* **Oversubscription** is checked, not clamped: summing every tenant's
  compute-busy seconds per device must stay within the horizon, since
  allotments are exclusive — :meth:`FleetTrace.oversubscribed_devices`
  must come back empty, and the fleet tests assert it.

Entry points: :func:`simulate_fleet`, also reachable as
``dora.simulate(fleet, mode="fleet")``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core.adapter import DynamicsEvent
from ..core import events as kernel
from ..core.events import (DEFAULT_N_REQUESTS, AdapterAction, RequestLog,
                           ServingLoad, ServingTrace, _json_num)

#: Seed stride between tenants so their arrival processes are
#: independent but each stays deterministic per (fleet seed, tenant).
_TENANT_SEED_STRIDE = 9973


@dataclasses.dataclass(frozen=True)
class FleetAction:
    """One tenant-visible runtime reaction during a fleet run."""

    t: float
    label: str
    tenant: str
    action: str             # "reschedule" | "replan" | "rebalance"
    react_s: float
    stall_s: float
    latency_after: float
    allotment: Tuple[int, ...]


@dataclasses.dataclass
class FleetTrace:
    """Everything one multi-tenant serving simulation produced."""

    fleet: str
    tenants: "OrderedDict[str, ServingTrace]"
    actions: List[FleetAction]
    assignments: Dict[str, Tuple[int, ...]]   # final allotments
    per_device_energy: Dict[int, float]       # fleet-wide, idle billed once
    per_device_busy: Dict[int, float]         # summed across tenants
    horizon_s: float
    rebalances: int
    #: (t, {tenant: allotment}) snapshots — the ownership history the
    #: idle-draw proration was computed from
    ownership: List[Tuple[float, Dict[str, Tuple[int, ...]]]] = \
        dataclasses.field(default_factory=list)
    #: chaos-engine fault records (kind, target, onset/detect/restore
    #: times, mttr_s) — empty for fault-free runs
    faults: List[Dict[str, object]] = dataclasses.field(default_factory=list)
    #: mean time-to-recovery over service-affecting faults, ``None``
    #: when no fault touched any tenant
    mttr_s: Optional[float] = None

    @property
    def energy(self) -> float:
        return sum(self.per_device_energy.values())

    @property
    def slo_attainment(self) -> float:
        """Worst tenant's SLO attainment (the fleet is only as good as
        its unhappiest tenant)."""
        return min((t.slo_attainment for t in self.tenants.values()),
                   default=1.0)

    @property
    def n_failed(self) -> int:
        return sum(t.n_failed for t in self.tenants.values())

    @property
    def n_retried(self) -> int:
        return sum(t.n_retried for t in self.tenants.values())

    @property
    def failed_rate(self) -> float:
        n = sum(len(t.requests) for t in self.tenants.values())
        return self.n_failed / n if n else 0.0

    def utilization(self, device: int) -> float:
        if self.horizon_s <= 0.0:
            return 0.0
        return self.per_device_busy.get(device, 0.0) / self.horizon_s

    @property
    def oversubscribed_devices(self) -> List[int]:
        """Devices booked for more compute-seconds than the run holds —
        always empty under exclusive allotments (asserted by tests)."""
        return sorted(d for d in self.per_device_busy
                      if self.utilization(d) > 1.0 + 1e-6)

    def to_dict(self) -> Dict[str, object]:
        return {
            "fleet": self.fleet,
            "horizon_s": _json_num(self.horizon_s),
            "energy_j": _json_num(self.energy),
            "slo_attainment_worst": self.slo_attainment,
            "failed_requests": self.n_failed,
            "rebalances": self.rebalances,
            "assignments": {k: list(v)
                            for k, v in self.assignments.items()},
            "ownership": [{"t": _json_num(t),
                           "assignments": {k: list(v)
                                           for k, v in snap.items()}}
                          for t, snap in self.ownership],
            "per_device_energy_j": {str(d): _json_num(e) for d, e in
                                    sorted(self.per_device_energy.items())},
            "per_device_utilization": {str(d): self.utilization(d) for d in
                                       sorted(self.per_device_energy)},
            "oversubscribed_devices": self.oversubscribed_devices,
            **({"retried_requests": self.n_retried,
                "mttr_s": _json_num(self.mttr_s),
                "faults": [{k: _json_num(v) if isinstance(v, float) else v
                            for k, v in rec.items()}
                           for rec in self.faults]}
               if self.faults or self.mttr_s is not None else {}),
            "tenants": {name: t.to_dict()
                        for name, t in self.tenants.items()},
            "actions": [{
                "t": a.t, "label": a.label, "tenant": a.tenant,
                "action": a.action, "react_s": _json_num(a.react_s),
                "stall_s": _json_num(a.stall_s),
                "latency_after_s": _json_num(a.latency_after),
                "allotment": list(a.allotment),
            } for a in self.actions],
        }

    def summary(self) -> str:
        lines = [f"fleet {self.fleet}: {len(self.tenants)} tenants over "
                 f"{self.horizon_s:.1f}s, total energy {self.energy:.1f} J"
                 f", {self.rebalances} rebalances"]
        for name, t in self.tenants.items():
            def fmt(x: float) -> str:
                return (f"{x * 1e3:.0f} ms" if math.isfinite(x)
                        else "unserved")
            lines.append(
                f"  {name:24s} devs={list(self.assignments[name])!s:12s} "
                f"{len(t.requests)} reqs @ {t.load.rate:g}/s  "
                f"p50/p99 {fmt(t.p50)}/{fmt(t.p99)}  "
                f"SLO {t.slo_attainment:.1%}")
        for a in self.actions:
            stall = f" stall {a.stall_s:.2f}s" if a.stall_s > 0 else ""
            lines.append(f"  t={a.t:6.1f}s  [{a.tenant}] {a.label:40s} -> "
                         f"{a.action}{stall}")
        return "\n".join(lines)


def _default_span(timeline) -> float:
    last = max((ev.t for _, ev in timeline), default=0.0)
    return max(60.0, last * 1.25)


def simulate_fleet(fleet, *,
                   loads: Optional[Dict[str, ServingLoad]] = None,
                   events=None,
                   session=None,
                   span_s: Optional[float] = None,
                   seed: int = 0,
                   chunk: Optional[int] = None,
                   faults=None,
                   resilience=None,
                   recovery: str = "ladder",
                   control=None,
                   **overrides) -> FleetTrace:
    """Run one multi-tenant request-level serving simulation.

    ``fleet`` — a registered fleet-scenario name, a
    :class:`~repro_torch.fleet.FleetScenario`, or a list of tenant scenario
    refs.  ``loads`` overrides per-tenant :class:`ServingLoad`\\ s; by
    default each tenant arrives at its registered ``request_rate`` for
    ``span_s`` seconds (default: 60 s or 1.25x the last timeline
    event).  ``events`` overrides the fleet timeline.  Pass an armed
    ``session=`` (from ``dora.serve_fleet``) to reuse its plans;
    ``chunk`` bounds the kernel's vectorization width (a validation
    knob — results are invariant to it); keyword ``overrides``
    otherwise flow to ``dora.serve_fleet``.

    ``faults=`` / ``resilience=`` / ``recovery=`` mirror
    :func:`repro_torch.sim.serving.simulate_requests`: any fault content
    (a :class:`~repro_torch.resilience.FaultScript` or fault-carrying
    timeline events) delegates the run to the multi-tenant chaos
    engine with detection-latency-aware recovery.

    ``control=`` (a :class:`~repro_torch.control.plane.ControlConfig`) arms
    kernel-side priority preemption per tenant — ``priority > 0``
    request classes jump queued batch admissions on their tenant's
    pipeline.  Battery SoC is single-tenant only (use
    :func:`simulate_requests`).
    """
    from .. import dora            # local import: dora lazily imports sims
    from ..fleet import resolve_fleet

    topology = overrides.pop("topology", None)
    fs = resolve_fleet(fleet, topology=topology)
    if session is None:
        session = dora.serve_fleet(fs, **overrides)
    else:
        have = session.scenario.name if session.scenario is not None \
            else session.plan.name
        if have != fs.name:
            raise ValueError(f"session was armed for fleet {have!r}, "
                             f"not {fs.name!r}")
        if overrides or topology is not None:
            raise ValueError("overrides are ignored when reusing a "
                             "session; pass them to dora.serve_fleet")
    topo = session.planner.topo
    timeline = kernel.normalize_timeline(
        events if events is not None else fs.timeline)
    span = span_s if span_s is not None else _default_span(timeline)

    names = [t.name for t in fs.tenants]
    tenant_loads: Dict[str, ServingLoad] = {}
    for i, tn in enumerate(fs.tenants):
        load = (loads or {}).get(tn.name)
        if load is None:
            active0 = session.sessions[tn.name].current
            rate = tn.request_rate or 0.5 / max(active0.latency, 1e-9)
            n = max(8, min(int(math.ceil(rate * span)),
                           2 * DEFAULT_N_REQUESTS))
            load = ServingLoad(
                rate=rate, n_requests=n,
                seed=seed + i * _TENANT_SEED_STRIDE,
                arrival=getattr(tn, "arrival", None),
                classes=tuple(getattr(tn, "request_classes", ()) or ()))
        tenant_loads[tn.name] = load

    if faults is not None and hasattr(faults, "events"):
        faults = faults.events()
    if faults:
        timeline = sorted(timeline + kernel.normalize_timeline(faults),
                          key=lambda item: item[1].t)
    if resilience is not None or any(ev.is_fault for _, ev in timeline):
        from ..resilience import ResilienceConfig
        from ..resilience.engine import run_chaos_fleet
        return run_chaos_fleet(fs=fs, session=session, loads=tenant_loads,
                               timeline=timeline,
                               config=resilience or ResilienceConfig(),
                               recovery=recovery)

    def freeze(name: str) -> kernel.ActivePlan:
        tp = session.plan.tenants[name]
        return kernel.freeze_plan(session.sessions[name].current,
                                  tp.allotment, topo)

    streams: Dict[str, kernel.Stream] = {}
    for n in names:
        t_load = tenant_loads[n]
        t_arr = t_load.sample_arrivals()
        preempt = None
        if control is not None and control.preemption:
            preempt = kernel.preemption_spec(
                t_load.classes, t_load.sample_class_ids(len(t_arr)),
                control.preempt_overhead_s)
        streams[n] = kernel.Stream(t_arr, plan=freeze(n), chunk=chunk,
                                   preempt=preempt)
    actions: List[FleetAction] = []
    presence = kernel.PresenceTracker(topo.n)
    ownership = kernel.OwnershipTracker(session.plan.assignments)

    def fire(label: str, ev: DynamicsEvent) -> None:
        presence.apply(ev)
        reacted = session.on_dynamics(ev)
        for act in reacted:
            if act.tenant not in streams:    # whole-fleet marker row
                actions.append(FleetAction(
                    t=ev.t, label=label, tenant=act.tenant,
                    action=act.action, react_s=act.react_s,
                    stall_s=act.stall_s, latency_after=act.latency_after,
                    allotment=act.allotment))
                continue
            streams[act.tenant].stall(ev.t, act.stall_s)
            actions.append(FleetAction(
                t=ev.t, label=label, tenant=act.tenant, action=act.action,
                react_s=act.react_s, stall_s=act.stall_s,
                latency_after=act.latency_after, allotment=act.allotment))
        if reacted:
            for n in names:                  # allotments may have moved
                streams[n].plan = freeze(n)
            ownership.update(ev.t, session.plan.assignments)

    kernel.replay(timeline, [streams[n] for n in names], fire)

    horizon = max([0.0,
                   *(float(s.arrivals[-1]) for s in streams.values()
                     if len(s.arrivals)),
                   *(s.last_finite_finish() for s in streams.values()),
                   *(ev.t for _, ev in timeline)])

    # -- energy attribution: idle draw once per device over its presence
    # interval, prorated across owning tenants by ownership interval;
    # service energy to the tenant that admitted the request
    presence_iv = presence.intervals(horizon)
    fleet_idle = presence.seconds(horizon)
    fleet_energy: Dict[int, float] = {
        d: dev.p_idle * fleet_idle.get(d, 0.0)
        for d, dev in enumerate(topo.devices)}
    tenant_idle: Dict[str, Dict[int, float]] = {n: {} for n in names}
    for d, spans in ownership.spans(horizon).items():
        for lo, hi, owner in spans:
            if owner not in tenant_idle:
                continue
            secs = kernel.overlap_seconds(presence_iv.get(d, ()), lo, hi)
            if secs > 0.0:
                tenant_idle[owner][d] = \
                    tenant_idle[owner].get(d, 0.0) + secs

    final = session.plan.assignments
    traces: "OrderedDict[str, ServingTrace]" = OrderedDict()
    fleet_busy: Dict[int, float] = {}
    for tn in fs.tenants:
        name = tn.name
        load = tenant_loads[name]
        stream = streams[name]
        for d, e in stream.service_energy.items():
            fleet_energy[d] = fleet_energy.get(d, 0.0) + e
        for d, b in stream.busy.items():
            fleet_busy[d] = fleet_busy.get(d, 0.0) + b
        tenant_energy = dict(stream.service_energy)
        idle_s = tenant_idle[name]
        for d, secs in idle_s.items():
            tenant_energy[d] = tenant_energy.get(d, 0.0) \
                + topo.devices[d].p_idle * secs
        slo = load.slo_s if load.slo_s is not None else tn.qoe.t_qoe
        arr, starts, finishes = stream.arrays()
        log = RequestLog(arr, starts, finishes,
                         class_id=load.sample_class_ids(len(arr)),
                         classes=load.classes)
        traces[name] = ServingTrace(
            scenario=f"{fs.name}/{name}", strategy="fleet", load=load,
            slo_s=slo, requests=log,
            actions=[AdapterAction(t=a.t, label=a.label, action=a.action,
                                   react_s=a.react_s, stall_s=a.stall_s,
                                   latency_after=a.latency_after)
                     for a in actions if a.tenant == name],
            per_device_energy=tenant_energy,
            per_device_busy=dict(stream.busy),
            horizon_s=float(horizon),
            per_device_idle_s=idle_s)

    return FleetTrace(fleet=fs.name, tenants=traces, actions=actions,
                      assignments={k: tuple(v) for k, v in final.items()},
                      per_device_energy=fleet_energy,
                      per_device_busy=fleet_busy,
                      horizon_s=float(horizon),
                      rebalances=session.rebalances,
                      ownership=ownership.history)


__all__ = ["FleetAction", "FleetTrace", "simulate_fleet"]
