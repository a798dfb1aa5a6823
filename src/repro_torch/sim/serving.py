# A copy of src/repro/sim/serving.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""Request-level serving simulator (§4.3 under open-loop load).

The plan-level stack answers "how fast is one iteration/token?";
a serving deployment is judged on what *requests* experience: tail
latency and SLO attainment under queueing, runtime dynamics and fleet
churn.  This module is a thin adapter over the shared serving kernel
(:mod:`repro_torch.core.events`), which owns arrival generation, the
vectorized admission/queueing recurrence, dynamics segmentation and
energy attribution; what remains here is the strategy wiring:

* **Arrivals** — the load's arrival process (Poisson at the scenario's
  registered ``request_rate`` by default; diurnal/MMPP/flash-crowd
  curves and multi-class SLO tiers via :class:`ServingLoad`) or an
  explicit arrival trace.
* **Service** — a fluid pipeline model of the active plan: a request
  admitted at ``s`` finishes at ``s + plan.latency``; the pipeline
  admits the next request after the bottleneck interval
  (:meth:`~repro_torch.core.engine.ScheduleResult.admission_interval` — the
  busiest stage executor / network resource per request from the
  Phase-2 schedule; full ``latency`` for training, where the flush +
  gradient sync serialize iterations).  Between dynamics events the
  kernel serves whole arrival segments as array ops, so 10^6-request
  traces run in seconds.
* **Dynamics** — the scenario's timeline plays out mid-run.  With the
  ``dora`` strategy, events flow through the armed
  :class:`~repro_torch.dora.ServeSession` (cumulative conditions, §4.3
  reschedule/replan, migration stalls pause admissions); device
  ``leave``/``join`` churn shrinks/grows the fleet and forces a replan
  on the surviving topology.  Non-adaptive baseline strategies keep
  their static plan: it is repriced under the merged conditions with
  fluid-fair contention, and churn that removes a device the plan
  placed layers on makes every subsequent request fail until the
  device rejoins.
* **Energy** — idle draw is billed once per device over its *presence
  interval* (a device that leaves at ``t`` stops drawing idle power at
  ``t``; see ``ServingTrace.per_device_idle_s``), and each request adds
  only the active plan's non-idle per-device energy (compute + DVFS +
  network bytes — the plan's energy minus the idle draw its window
  already prices).  Overlapping pipeline windows therefore never bill
  the same idle second twice.

The public API is unchanged: :func:`simulate_requests` (also reachable
as ``dora.simulate(scenario, mode="requests")``) returns a
:class:`ServingTrace` with p50/p95/p99 latency, SLO attainment %,
per-device energy and every adapter action.  Moved internals
(``poisson_arrivals``, ``normalize_timeline``, ``_ActivePlan``, …) stay
importable from here behind a :class:`DeprecationWarning` shim.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..control.battery import SOC_CHECK_LABEL, BatteryTracker
from ..control.plane import ControlConfig, StaticPlane
from ..core.adapter import DynamicsEvent
from ..core.scheduler import NetworkScheduler
from ..core import events as kernel
from ..core.events import (DEFAULT_N_REQUESTS, AdapterAction, RequestLog,
                           RequestRecord, ServingLoad, ServingTrace)


def default_load(scenario, plan_latency: float) -> ServingLoad:
    """The scenario's registered request rate (plus any registered
    arrival process / request classes), or a half-capacity fallback for
    ad-hoc scenarios that don't declare one."""
    rate = getattr(scenario, "request_rate", None)
    if rate is None:
        rate = 0.5 / max(plan_latency, 1e-9)
    return ServingLoad(
        rate=rate,
        arrival=getattr(scenario, "arrival", None),
        classes=tuple(getattr(scenario, "request_classes", ()) or ()))


def simulate_requests(scenario,
                      *,
                      strategy: str = "dora",
                      load: Optional[ServingLoad] = None,
                      events=None,
                      session=None,
                      report=None,
                      arrivals: Optional[Sequence[float]] = None,
                      chunk: Optional[int] = None,
                      faults=None,
                      resilience=None,
                      recovery: str = "ladder",
                      control: Optional[ControlConfig] = None,
                      **overrides) -> ServingTrace:
    """Run one request-level serving simulation.

    ``strategy="dora"`` arms (or reuses, via ``session=``) a
    :class:`~repro_torch.dora.ServeSession` and lets the runtime adapter react
    to every timeline event; any other registered strategy plans once
    (or reuses an existing ``report=`` from ``dora.plan`` of the same
    scenario and strategy) and stays static — its plan is repriced
    under the merged conditions (fluid-fair contention) and breaks
    outright when churn removes a device it placed layers on.
    ``events`` defaults to the scenario's registered timeline;
    ``arrivals`` (explicit trace, seconds) overrides the load's arrival
    process.  ``chunk`` bounds the kernel's vectorization width (a
    validation knob — results are invariant to it).  Keyword
    ``overrides`` flow to ``dora.serve``/``dora.plan``.

    **Chaos.** ``faults=`` injects *unannounced* failures — a
    :class:`~repro_torch.resilience.FaultScript`, or any event sequence
    carrying ``crash``/``link_down``/``link_up``/``straggler`` fields
    (the ``faulty_sites`` scenario family registers such timelines).
    Whenever fault content is present (or ``resilience=`` is passed),
    the run is delegated to the chaos engine
    (:mod:`repro_torch.resilience.engine`): failures take effect silently at
    onset and are only *acted on* one heartbeat detection window later
    (``miss_limit * beat_interval``, pumped through a real
    ``runtime.heartbeat.Coordinator``); blind-window requests fail or
    time out and are retried per the :class:`RetryPolicy`;
    ``recovery=`` picks the dora reaction — ``"ladder"`` (precomputed
    fallback plan, background warm replan) or ``"replan"`` (naive
    replan-on-detect).  With no fault content this function is
    bit-identical to the plain Lindley kernel path.

    **Control plane.** ``control=`` (a
    :class:`~repro_torch.control.plane.ControlConfig`, defaulting to the
    session's own) arms the within-plan mechanisms: ``preemption``
    lets ``priority > 0`` request classes jump queued batch admissions
    at the bottleneck stage; ``battery`` integrates per-device SoC
    (``DeviceProfile.battery_j``) against the kernel's energy
    attribution at ``soc_check_interval_s`` checkpoints, kills emptied
    devices mid-run, and — with ``battery_aware`` — evacuates them
    *before* the projected death.  With every mechanism off this is
    bit-identical to the historical path.  Chaos runs ignore the
    sim-side mechanisms (streamed migration, which lives in the
    adapter, still applies).
    """
    from .. import dora  # local import: dora lazily imports this module

    sc = dora.get_scenario(scenario)
    if session is not None and strategy != "dora":
        raise ValueError("session= implies the adaptive dora strategy; "
                         f"got strategy={strategy!r}")
    scheduler: Optional[NetworkScheduler] = None
    if strategy == "dora":
        if report is not None:
            raise ValueError("the dora strategy reuses a session=, "
                             "not a report=")
        if session is None:
            session = dora.serve(sc, **overrides)
        else:
            have = session.report.scenario.name
            if have != sc.name:
                raise ValueError(f"session was served for scenario {have!r},"
                                 f" not {sc.name!r}")
            if overrides:
                raise ValueError("overrides are ignored when reusing a "
                                 "session; pass them to dora.serve instead")
        report = session.report
        topo = report.topology
        active = kernel.freeze_plan(session.current, session.active, topo)
    else:
        if report is None:
            report = dora.plan(sc, strategy=strategy, **overrides)
        elif report.scenario.name != sc.name or report.strategy != strategy:
            raise ValueError(
                f"report= was planned for ({report.scenario.name!r}, "
                f"{report.strategy!r}), not ({sc.name!r}, {strategy!r})")
        topo = report.topology
        scheduler = NetworkScheduler(topo, report.qoe)
        active = kernel.freeze_plan(report.best, range(topo.n), topo)
    qoe = report.qoe

    if load is None:
        load = default_load(sc, active.latency)
    slo = load.slo_s if load.slo_s is not None else qoe.t_qoe

    if arrivals is not None:
        arr = np.asarray(sorted(float(a) for a in arrivals))
        if len(arr) and arr[0] < 0.0:
            raise ValueError("arrival times must be non-negative")
    else:
        arr = load.sample_arrivals()

    timeline = kernel.normalize_timeline(
        events if events is not None else sc.timeline)

    if faults is not None and hasattr(faults, "events"):
        faults = faults.events()
    if faults:
        timeline = sorted(timeline + kernel.normalize_timeline(faults),
                          key=lambda item: item[1].t)
    if resilience is not None or any(ev.is_fault for _, ev in timeline):
        from ..resilience import ResilienceConfig
        from ..resilience.engine import run_chaos
        return run_chaos(sc=sc, strategy=strategy, session=session,
                         report=report, scheduler=scheduler, load=load,
                         slo=slo, arr=arr, timeline=timeline,
                         config=resilience or ResilienceConfig(),
                         recovery=recovery)

    # static-strategy runtime view (the dora path keeps its own inside
    # the ServeSession's ControlPlane)
    static = StaticPlane(topo.n, active.devices)

    if control is None and session is not None:
        control = session.control

    class_id = load.sample_class_ids(len(arr))
    preempt = None
    if control is not None and control.preemption:
        preempt = kernel.preemption_spec(load.classes, class_id,
                                         control.preempt_overhead_s)

    battery: Optional[BatteryTracker] = None
    present = set(range(topo.n))
    if control is not None and control.battery:
        if strategy != "dora":
            raise ValueError("battery tracking needs the adaptive dora "
                             "strategy (the control plane reacts to SoC)")
        battery = BatteryTracker(topo.devices)
        if not battery.capacity:
            battery = None          # no battery-backed device to track
    if battery is not None:
        # inject SoC checkpoints; fire() intercepts them by label
        # *before* they could reach the session's reaction path (an
        # empty event would otherwise trigger a refine)
        t_hi = max([float(arr[-1]) if len(arr) else 0.0,
                    *(ev.t for _, ev in timeline)])
        step = control.soc_check_interval_s
        checks = [(SOC_CHECK_LABEL, DynamicsEvent(t=k * step))
                  for k in range(1, int(t_hi / step) + 1)]
        timeline = sorted(timeline + checks, key=lambda kv: kv[1].t)

    stream = kernel.Stream(arr, plan=active, chunk=chunk, preempt=preempt)
    presence = kernel.PresenceTracker(topo.n)
    actions: List[AdapterAction] = []

    def fire(label: str, ev: DynamicsEvent) -> None:
        if battery is not None and label == SOC_CHECK_LABEL:
            newly = battery.advance(ev.t, stream.service_energy, present)
            for lbl, bev, act, react, stall in session.plane.on_soc(
                    ev.t, battery, newly_dead=newly, config=control):
                presence.apply(bev)
                present.difference_update(bev.leave)
                present.update(bev.join)
                stream.stall(bev.t, stall)
                if act == "degraded" or session.degraded:
                    stream.alive = False
                    lat = math.inf
                else:
                    stream.alive = True
                    stream.plan = kernel.freeze_plan(
                        session.current, session.plan_fleet, topo)
                    lat = stream.plan.latency
                actions.append(AdapterAction(
                    t=ev.t, label=lbl, action=act, react_s=react,
                    stall_s=stall, latency_after=lat))
            return
        presence.apply(ev)
        present.difference_update(ev.leave)
        present.update(ev.join)
        if strategy == "dora":
            new, act, react = session.on_dynamics(ev)
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            stream.stall(ev.t, stall)
            if act == "degraded":
                # no servable plan on the survivors: requests fail
                # until a rejoin replans successfully
                stream.alive = False
                lat = math.inf
            else:
                stream.alive = True
                stream.plan = kernel.freeze_plan(new, session.plan_fleet,
                                                 topo)
                lat = stream.plan.latency
            actions.append(AdapterAction(t=ev.t, label=label, action=act,
                                         react_s=react, stall_s=stall,
                                         latency_after=lat))
            return
        # static baseline: merge conditions, apply churn, reprice
        t0 = time.perf_counter()
        stream.alive = static.apply(ev)
        if not stream.alive:
            act, lat = "degraded", math.inf
        else:
            repriced = scheduler.evaluate_fair(
                report.best,
                compute_speed=dict(static.state.compute_speed),
                bandwidth_scale=dict(static.state.bandwidth_scale))
            stream.plan = kernel.freeze_plan(repriced, range(topo.n), topo)
            act, lat = "repriced", stream.plan.latency
        actions.append(AdapterAction(t=ev.t, label=label, action=act,
                                     react_s=time.perf_counter() - t0,
                                     stall_s=0.0, latency_after=lat))

    kernel.replay(timeline, [stream], fire)

    arr_out, starts, finishes = stream.arrays()
    horizon = max([0.0, float(arr[-1]) if len(arr) else 0.0,
                   stream.last_finite_finish(),
                   *(ev.t for _, ev in timeline)])
    idle_s = presence.seconds(horizon)
    per_device_energy: Dict[int, float] = {}
    for d, dev in enumerate(topo.devices):
        per_device_energy[d] = stream.service_energy.get(d, 0.0) \
            + dev.p_idle * idle_s.get(d, 0.0)

    log = RequestLog(arr_out, starts, finishes,
                     class_id=(class_id[:len(arr_out)]
                               if class_id is not None else None),
                     classes=load.classes)
    return ServingTrace(scenario=sc.name, strategy=strategy, load=load,
                        slo_s=slo, requests=log, actions=actions,
                        per_device_energy=per_device_energy,
                        per_device_busy=dict(stream.busy),
                        horizon_s=float(horizon),
                        per_device_idle_s=idle_s)


#: moved internals kept importable with a DeprecationWarning (the
#: public serving API above is unchanged)
_MOVED = {
    "poisson_arrivals": "poisson_arrivals",
    "normalize_timeline": "normalize_timeline",
    "_ActivePlan": "ActivePlan",
    "_freeze": "freeze_plan",
    "_service_interval": "service_interval",
}


def __getattr__(name: str):
    target = _MOVED.get(name)
    if target is not None:
        warnings.warn(
            f"repro_torch.sim.serving.{name} moved to "
            f"repro_torch.core.events.{target}; import it from there",
            DeprecationWarning, stacklevel=2)
        return getattr(kernel, target)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ServingLoad", "RequestRecord", "RequestLog", "AdapterAction",
    "ServingTrace", "default_load", "simulate_requests",
    "DEFAULT_N_REQUESTS",
]
