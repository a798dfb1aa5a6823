# A copy of src/repro/control/plane.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's reactions must match the reference's action for action.
"""The real-time control plane — Dora's *single* dynamics-reaction layer.

Before this module existed, the §4.3 adapter logic was smeared across
four layers (``core/adapter.py``, ``dora.py``, ``fleet/session.py`` and
``resilience/engine.py``), each re-implementing state accumulation,
replan triggering and migration-stall billing slightly differently.
The control plane collapses those paths into one place:

* :class:`ControlPlane` owns one :class:`~repro_torch.dora.ServeSession`'s
  cumulative :class:`~repro_torch.core.adapter.RuntimeState`, plan arming,
  replan/fallback decisions and migration pricing.  ``ServeSession``,
  the fallback ladder and the chaos kernel are thin adapters over it.
* :class:`FleetControlPlane` does the same for a multi-tenant
  :class:`~repro_torch.fleet.session.FleetSession` (event routing, rebalance,
  fallback adoption).
* :class:`StaticPlane` is the believed-state accumulator for
  *non-adaptive* baseline strategies (shared by the plain serving
  simulator and the chaos engine).
* :func:`react_once` is the session-less single-event reaction the
  standalone :meth:`RuntimeAdapter.on_dynamics` delegates to.

On top of the unified plane sit the three within-plan mechanisms the
replan-only adapter could not express, switched by
:class:`ControlConfig`: stage-level priority preemption (kernel-side,
:class:`repro_torch.core.events.PreemptionSpec`), battery state-of-charge
(:mod:`repro_torch.control.battery` + :meth:`ControlPlane.on_soc`) and
DEFER-style streamed migration
(``AdapterConfig.streamed_migration`` — overlap next-plan weight
transfer with current-plan execution).  With every mechanism at its
default-off setting the plane is bit-identical to the pre-refactor
per-session reaction paths.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from ..core.adapter import (DynamicsEvent, RuntimeState, cold_load_stall)
from ..core.planner import DoraPlanner
from ..core.plans import ParallelismPlan

__all__ = [
    "ControlConfig", "ControlPlane", "FleetControlPlane", "StaticPlane",
    "react_once", "_remap_plan",
]


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Which control-plane mechanisms are armed, and their knobs.

    Everything defaults *off*: a session served without a config (or
    with ``ControlConfig()``) behaves bit-identically to the
    pre-control-plane runtime.
    """

    #: interactive :class:`~repro_torch.core.events.RequestClass` requests
    #: (``priority > 0``) preempt queued batch admissions at the
    #: bottleneck stage (per-class Lindley recurrence in the kernel)
    preemption: bool = False
    #: pipeline-state save/restore overhead one preemption costs the
    #: displaced batch request (seconds)
    preempt_overhead_s: float = 0.005
    #: track per-device battery state of charge (``Device.battery_j``)
    #: and kill devices whose battery empties mid-run
    battery: bool = False
    #: proactively evacuate (announced leave-churn, async switch) a
    #: device *before* its projected battery death, instead of paying
    #: the unannounced synchronous switch at death
    battery_aware: bool = False
    #: how often the serving simulator checkpoints SoC (seconds)
    soc_check_interval_s: float = 5.0
    #: evacuate when projected time-to-death < margin × check interval
    soc_margin: float = 3.0
    #: DEFER-style streamed migration: overlap next-plan weight
    #: transfer with current-plan execution on the synchronous switch
    #: path (see ``AdapterConfig.streamed_migration``)
    streamed_migration: bool = False
    #: fraction of link bandwidth the stream may steal from serving
    stream_bw_fraction: float = 0.5


def _remap_plan(plan: ParallelismPlan,
                mapping: Dict[int, int]) -> Optional[ParallelismPlan]:
    """Project a plan into a re-indexed fleet (for delta-switch pricing
    across churn): stages keep only surviving devices, re-numbered via
    ``mapping``. Returns ``None`` when no stage survives at all."""
    stages = []
    for s in plan.stages:
        devs = [mapping[d] for d in s.devices if d in mapping]
        if not devs:
            continue
        split = {mapping[d]: s.microbatch_split[d]
                 for d in s.devices if d in mapping}
        stages.append(dataclasses.replace(s, devices=devs,
                                          microbatch_split=split))
    if not stages:
        return None
    return dataclasses.replace(plan, stages=stages)


def react_once(adapter, current: ParallelismPlan, event: DynamicsEvent,
               replan_fn=None, state: Optional[RuntimeState] = None
               ) -> Tuple[ParallelismPlan, str, float]:
    """Session-less single-event reaction (the legacy
    ``RuntimeAdapter.on_dynamics`` semantics): merge the event into the
    accumulated ``state`` (or take it as the complete picture) and let
    the adapter's pricing primitive react to the merged conditions."""
    prior = state if state is not None else RuntimeState()
    return adapter.react(current, prior.apply(event), prior.delta(event),
                         replan_fn)


class ControlPlane:
    """One ``ServeSession``'s reaction layer: cumulative state, plan
    arming, replan/fallback decisions and migration pricing.

    The plane mutates the session it serves (``state``, ``current``,
    ``adapter``, ``active``, ``plan_fleet``, ``plans``, ``degraded``)
    exactly as the pre-refactor per-session paths did — the session's
    public fields remain the single source of truth, so existing
    callers observe identical behavior.
    """

    def __init__(self, session, config: Optional[ControlConfig] = None):
        self.session = session
        self.config = config or ControlConfig()

    # -- state translation -------------------------------------------------------
    def translate(self, state: RuntimeState) -> RuntimeState:
        """Original-index conditions → plan-fleet index space.
        Bandwidth entries for links that left with their devices are
        filtered out (they come back into force on rejoin)."""
        session = self.session
        if session.plan_fleet == tuple(range(session.report.topology.n)):
            return state
        mapping = {orig: pos for pos, orig in enumerate(session.plan_fleet)}
        alive = session.adapter.topo.resources
        return RuntimeState(
            compute_speed={mapping[d]: v
                           for d, v in state.compute_speed.items()
                           if d in mapping},
            bandwidth_scale={k: v for k, v in state.bandwidth_scale.items()
                             if k in alive})

    # -- the single reaction path ------------------------------------------------
    def on_dynamics(self, event: DynamicsEvent,
                    replan: bool = True) -> Tuple[ParallelismPlan, str, float]:
        """Feed one runtime event to the adapter; track the active plan.

        Returns (new plan, action taken, reaction seconds).  ``replan``
        permits full replanning on large shifts; small fluctuations are
        absorbed with network-only rescheduling either way.  Device
        ``leave``/``join`` churn always replans (the fleet changed).
        The event is merged into the session's cumulative ``state``, so
        successive partial events compound instead of overwriting each
        other.
        """
        session = self.session
        if event.is_churn:
            return self.churn(event)
        if event.is_fault and not event.is_announced:
            # silent fault: the session cannot observe it (that is the
            # point of unannounced faults) — the resilience engine
            # reacts on *detection*, never on onset
            return session.current, "unobserved", 0.0
        if session.degraded:
            # no servable plan for the surviving fleet: absorb the
            # conditions into state so a recovery replan sees them
            session.state = session.state.apply(event)
            return session.current, "degraded", 0.0
        prior = session.state
        merged = prior.apply(event)
        replan_fn = (lambda: list(session.plans)) if replan else None
        new, action, react = session.adapter.react(
            session.current, self.translate(merged), prior.delta(event),
            replan_fn)
        session.state = merged
        session.current = new
        return new, action, react

    def churn(self, event: DynamicsEvent
              ) -> Tuple[ParallelismPlan, str, float]:
        """Devices left/joined: replan from scratch on the new fleet."""
        session = self.session
        t0 = time.perf_counter()
        full = session.report.topology
        bad = [d for d in (*event.leave, *event.join)
               if not (0 <= d < full.n)]
        if bad:
            raise ValueError(f"churn references unknown devices {bad} "
                             f"(deployment has {full.n})")
        fleet = (set(session.active) - set(event.leave)) | set(event.join)
        if not fleet:
            raise ValueError("churn event would remove every device")
        merged = session.state.apply(event)
        keep = tuple(sorted(fleet))
        try:
            sub, mapping = full.subset(keep)
            # ``full`` is the session's calibrated topology, so the
            # default (identity) cost provider is correct here —
            # re-passing the original CostProvider would calibrate twice
            planner = DoraPlanner(session.report.graph, sub,
                                  session.report.qoe,
                                  partitioner_config=session.partitioner_config,
                                  scheduler_config=session.scheduler_config,
                                  adapter_config=session.adapter.config)
            # plan-fleet device -> new-fleet device (drops leavers)
            trans = {pos: mapping[orig]
                     for pos, orig in enumerate(session.plan_fleet)
                     if orig in mapping}
            if session.warm_replan and not event.join:
                # device-LEAVE churn is the latency-critical replan
                # (capacity dropped mid-service): warm-start from the
                # surviving candidate pool (§4.3 — steady-state replans
                # are ~pool-sized), falling back to the fresh DP when
                # nothing survives QoE-feasibly.  JOIN churn always runs
                # the full search — surviving candidates place no work
                # on the new device, so only a fresh DP can reclaim its
                # capacity, and the old plan keeps serving meanwhile.
                result = planner.replan(session.report.workload,
                                        session.plans, mapping=trans)
            else:
                result = planner.plan(session.report.workload)
        except (ValueError, RuntimeError):
            # survivors disconnect the routed topology (Topology.subset)
            # or admit no plan at all: go QoE-infeasible for this
            # segment instead of crashing. ``plan_fleet`` keeps the old
            # indexing so a later rejoin replans from it and recovers.
            session.active = keep
            session.state = merged
            session.degraded = True
            return session.current, "degraded", time.perf_counter() - t0
        adapter = planner.make_adapter(result)
        new = result.best
        cond = RuntimeState(
            compute_speed={mapping[d]: v
                           for d, v in merged.compute_speed.items()
                           if d in mapping},
            bandwidth_scale={k: v
                             for k, v in merged.bandwidth_scale.items()
                             if k in planner.topo.resources})
        if cond.compute_speed or cond.bandwidth_scale:
            new = adapter.scheduler.refine(
                new, compute_speed=dict(cond.compute_speed),
                bandwidth_scale=dict(cond.bandwidth_scale))
        # migration stall: the old plan re-indexed into the new fleet
        # prices delta switching (layers already resident stay put)
        proxy = _remap_plan(session.current, trans)
        if proxy is not None:
            stall = adapter.switch_cost(proxy, new)
        else:   # nothing survives: cold-load the whole new plan
            stall = cold_load_stall(new, sub, adapter.config)
        new.meta["switch_stall_s"] = stall
        new.meta["fleet"] = list(keep)
        new.meta["warm_replan"] = result.warm_start
        session.adapter = adapter
        session.active = keep
        session.plan_fleet = keep
        session.degraded = False
        session.state = merged
        session.plans = list(result.candidates)
        session.current = new
        return new, "replan", time.perf_counter() - t0

    # -- fallback adoption (resilience ladder) -----------------------------------
    def adopt_fallback(self, entry) -> float:
        """Switch the session to a precomputed
        :class:`~repro_torch.resilience.ladder.LadderEntry`.  Returns the
        stall (drain only — fallback weights are prestaged).  Mirrors
        :meth:`churn`'s bookkeeping."""
        session = self.session
        adapter = entry.planner.make_adapter(entry.result)
        new = entry.result.best
        merged = session.state
        cond = RuntimeState(
            compute_speed={entry.mapping[d]: v
                           for d, v in merged.compute_speed.items()
                           if d in entry.mapping},
            bandwidth_scale={k: v for k, v in merged.bandwidth_scale.items()
                             if k in entry.planner.topo.resources})
        if cond.compute_speed or cond.bandwidth_scale:
            new = adapter.scheduler.refine(
                new, compute_speed=dict(cond.compute_speed),
                bandwidth_scale=dict(cond.bandwidth_scale))
        stall = adapter.config.switch_drain_s
        new.meta["switch_stall_s"] = stall
        new.meta["fleet"] = list(entry.keep)
        new.meta["fallback"] = True
        session.adapter = adapter
        session.active = entry.keep
        session.plan_fleet = entry.keep
        session.degraded = False
        session.plans = list(entry.result.candidates)
        session.current = new
        return stall

    # -- detection reactions (chaos engine) --------------------------------------
    def on_detection(self, rec: Dict[str, object], *, config,
                     ladder=None) -> Tuple[str, float, float]:
        """React to one *detected* fault (the chaos engine's recovery
        path).  ``rec`` is the engine's fault record, ``config`` a
        :class:`~repro_torch.resilience.ResilienceConfig`.  Returns
        (action, react_s, stall_s)."""
        session = self.session
        kind, tgt = rec["kind"], rec["target"]
        if kind == "crash":
            if tgt not in session.active:
                return "unobserved", 0.0, 0.0
            t0 = time.perf_counter()
            if ladder is not None:
                stall = ladder.apply({tgt})
                if stall is not None:
                    ladder.build()       # background refresh of scopes
                    return "fallback", time.perf_counter() - t0, stall
            # naive replan-on-detect: the dead pipeline cannot overlap
            # the prefetch (async) nor stream ahead of the switch, so
            # the migration is priced fully synchronously
            cfg = session.adapter.config
            prev_async = cfg.async_switching
            prev_stream = cfg.streamed_migration
            cfg.async_switching = False
            cfg.streamed_migration = False
            try:
                new, act, react = self.on_dynamics(
                    DynamicsEvent(t=rec["t"], leave=(tgt,)))
            finally:
                session.adapter.config.async_switching = prev_async
                session.adapter.config.streamed_migration = prev_stream
                cfg.async_switching = prev_async
                cfg.streamed_migration = prev_stream
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            if ladder is not None:
                ladder.build()
            return act, react, stall
        if kind in ("link_down", "link_up"):
            scale = (config.link_down_scale if kind == "link_down" else 1.0)
            ev = DynamicsEvent(t=rec["t"] + config.detection_window_s,
                               bandwidth_scale={tgt: scale})
            new, act, react = self.on_dynamics(ev)
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            return act, react, stall
        # straggler (or its recovery): the believed speed realigns
        ev = DynamicsEvent(t=rec["t"] + config.detection_window_s,
                           compute_speed={tgt: rec.get("factor", 1.0)})
        new, act, react = self.on_dynamics(ev)
        stall = (float(new.meta.get("switch_stall_s", 0.0))
                 if act == "replan" else 0.0)
        return act, react, stall

    # -- battery state of charge (mechanism 2) -----------------------------------
    def on_soc(self, t: float, tracker, newly_dead=(), *,
               config: Optional[ControlConfig] = None
               ) -> List[Tuple[str, DynamicsEvent, str, float, float]]:
        """One SoC checkpoint: react to battery deaths, and (when
        ``battery_aware``) evacuate devices *before* their projected
        death.  Returns ``[(label, event, action, react_s, stall_s)]``
        — one row per churn the plane initiated (the serving simulator
        books presence/stalls from these).  ``config`` overrides the
        plane's own for this checkpoint (the serving simulator passes
        its per-run ``control=``)."""
        session = self.session
        cc = config if config is not None else self.config
        out: List[Tuple[str, DynamicsEvent, str, float, float]] = []
        for d in sorted(newly_dead):
            if d not in session.active:
                continue
            # unannounced death: the dead pipeline can neither overlap
            # the prefetch nor stream ahead — fully synchronous switch
            ev = DynamicsEvent(t=t, leave=(d,))
            cfg = session.adapter.config
            prev_async = cfg.async_switching
            prev_stream = cfg.streamed_migration
            cfg.async_switching = False
            cfg.streamed_migration = False
            try:
                new, act, react = self.on_dynamics(ev)
            finally:
                session.adapter.config.async_switching = prev_async
                session.adapter.config.streamed_migration = prev_stream
                cfg.async_switching = prev_async
                cfg.streamed_migration = prev_stream
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            out.append((f"battery dead: device {d}", ev, act, react, stall))
        if not cc.battery_aware:
            return out
        horizon = cc.soc_margin * cc.soc_check_interval_s
        for d in sorted(set(session.active) & set(tracker.capacity)):
            if session.degraded or len(session.active) <= 1:
                break
            if d in tracker.dead:
                continue
            ttd = tracker.time_to_death(d)
            if ttd is None or ttd >= horizon:
                continue
            # announced evacuation: the device is still serving, so the
            # replacement plan's weights prefetch asynchronously — the
            # priced stall is the drain, not a dead-pipeline reload
            ev = DynamicsEvent(t=t, leave=(d,))
            new, act, react = self.on_dynamics(ev)
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            out.append((f"battery low: evacuating device {d} "
                        f"(t_dead~{ttd:.0f}s)", ev, act, react, stall))
        return out


class StaticPlane:
    """Believed-state accumulator for a *non-adaptive* strategy: the
    merged conditions plus fleet membership.  A static plan never
    reroutes, so it is alive iff every device it placed layers on is
    still in the fleet; repricing under the merged conditions stays
    with the caller (it owns the scheduler)."""

    def __init__(self, n_devices: int, plan_devices):
        self.state = RuntimeState()
        self.fleet = set(range(n_devices))
        self.devices = set(plan_devices)

    def apply(self, event: DynamicsEvent) -> bool:
        """Merge one event; returns whether the static plan still has
        all its devices."""
        self.state = self.state.apply(event)
        self.fleet.difference_update(event.leave)
        self.fleet.update(event.join)
        return self.alive

    @property
    def alive(self) -> bool:
        return self.devices <= self.fleet


class FleetControlPlane:
    """One ``FleetSession``'s reaction layer: event routing to tenant
    planes, cross-tenant rebalancing and fleet fallback adoption."""

    def __init__(self, session, config: Optional[ControlConfig] = None):
        self.session = session
        self.config = config or ControlConfig()

    def on_dynamics(self, event: DynamicsEvent) -> list:
        """Feed one fleet-space runtime event to every affected tenant.

        Churn always rebalances; condition shifts route to the owning
        tenants' adapters, then trigger a rebalance if some tenant is
        left QoE-infeasible (and ``FleetConfig.rebalance_on_load``).
        Returns the actions taken, one per affected tenant.
        """
        from ..fleet.session import TenantAction

        session = self.session
        if event.is_churn:
            return self.rebalance(event)
        merged = session.state.apply(event)
        actions: List[TenantAction] = []
        for name, tp in session.plan.tenants.items():
            local = session._local_event(tp, event)
            if local is None:
                continue
            sess = session.sessions[name]
            new, act, react = sess.on_dynamics(local)
            stall = (float(new.meta.get("switch_stall_s", 0.0))
                     if act == "replan" else 0.0)
            actions.append(TenantAction(tenant=name, action=act,
                                        react_s=react, stall_s=stall,
                                        latency_after=new.latency,
                                        allotment=tp.allotment))
        session.state = merged
        if (session.planner.config.rebalance_on_load
                and any(not s.meets_qoe for s in session.sessions.values())):
            actions += self.rebalance(None)
        return actions

    def rebalance(self, event: Optional[DynamicsEvent]) -> list:
        """Re-run the assignment search on the surviving fleet and move
        devices between tenants; no-op when the incumbent assignment is
        still the joint winner."""
        from ..fleet.session import TenantAction, _orig_placement

        session = self.session
        t0 = time.perf_counter()
        if event is not None:
            full_n = session.planner.topo.n
            bad = [d for d in (*event.leave, *event.join)
                   if not (0 <= d < full_n)]
            if bad:
                raise ValueError(f"churn references unknown devices {bad} "
                                 f"(fleet has {full_n})")
            fleet = (set(session.active) - set(event.leave)) \
                | set(event.join)
            if len(fleet) < len(session.planner.tenants):
                raise ValueError(
                    f"churn leaves {sorted(fleet)}: not enough devices for "
                    f"{len(session.planner.tenants)} exclusive tenants")
            merged = session.state.apply(event)
        else:
            fleet = set(session.active)
            merged = session.state
        warm = {name: (list(sess.plans),
                       session.plan.tenants[name].allotment)
                for name, sess in session.sessions.items()}
        conditions = merged if (merged.compute_speed
                                or merged.bandwidth_scale) else None
        new_plan = session.planner.plan(devices=sorted(fleet), warm=warm,
                                        conditions=conditions,
                                        include=[session.plan.assignments])
        if (event is None
                and new_plan.assignments == session.plan.assignments):
            # load-shift probe: moving devices doesn't help — stay put
            return []
        actions: List[TenantAction] = []
        old_plan = session.plan
        # a kept session is only valid if its shared-link pricing is
        # unchanged too — another tenant's move can change the medium's
        # user count and with it this tenant's fair share
        shares_of = session.planner.link_shares
        old_shares = shares_of(list(old_plan.assignments.values()))
        new_shares = shares_of(list(new_plan.assignments.values()))
        new_sessions: Dict[str, object] = {}
        for name, tp in new_plan.tenants.items():
            old_tp = old_plan.tenants.get(name)
            if (old_tp is not None and old_tp.allotment == tp.allotment
                    and session.planner._factors_key(tp.allotment,
                                                     old_shares)
                    == session.planner._factors_key(tp.allotment,
                                                    new_shares)):
                # same allotment, same link shares: keep the tenant's
                # adapted session (pareto pool and cumulative state are
                # already right) — but a churn event can carry condition
                # shifts too, and those must still reach the tenant
                sess = session.sessions[name]
                local = session._local_event(tp, event) \
                    if event is not None else None
                if local is not None:
                    new, act, react = sess.on_dynamics(local)
                    actions.append(TenantAction(
                        tenant=name, action=act, react_s=react,
                        stall_s=(float(new.meta.get("switch_stall_s", 0.0))
                                 if act == "replan" else 0.0),
                        latency_after=new.latency,
                        allotment=tp.allotment))
                new_sessions[name] = sess
                continue
            sess = session._arm_tenant(tp,
                                       state=session._local_state(tp, merged))
            stall = 0.0
            if old_tp is not None:
                old_current = session.sessions[name].current
                if (_orig_placement(old_current, old_tp)
                        != _orig_placement(sess.current, tp)):
                    # only a placement that actually moved pays migration
                    stall = session._migration_stall(
                        old_current, old_tp, tp, sess)
            sess.current.meta["switch_stall_s"] = stall
            sess.current.meta["fleet"] = list(tp.allotment)
            new_sessions[name] = sess
            actions.append(TenantAction(
                tenant=name, action="rebalance",
                react_s=time.perf_counter() - t0, stall_s=stall,
                latency_after=sess.current.latency,
                allotment=tp.allotment))
        session.plan = new_plan
        session.sessions = new_sessions
        session.active = tuple(sorted(fleet))
        session.state = merged
        session.rebalances += 1
        if event is not None and not actions:
            # churn that didn't move any allotment still reacted
            actions.append(TenantAction(
                tenant="*", action="rebalance",
                react_s=time.perf_counter() - t0, stall_s=0.0,
                latency_after=math.nan, allotment=session.active))
        return actions

    def adopt_fallback(self, lost, new_plan) -> list:
        """Adopt a precomputed fleet fallback plan for the loss scope
        ``lost``: mirrors :meth:`rebalance` adoption, but every moved
        tenant pays only the drain (fallback weights are prestaged).
        Returns the tenant actions."""
        from ..fleet.session import TenantAction, _orig_placement

        session = self.session
        old_plan = session.plan
        shares_of = session.planner.link_shares
        old_shares = shares_of(list(old_plan.assignments.values()))
        new_shares = shares_of(list(new_plan.assignments.values()))
        actions: List[TenantAction] = []
        new_sessions: Dict[str, object] = {}
        for name, tp in new_plan.tenants.items():
            old_tp = old_plan.tenants.get(name)
            if (old_tp is not None and old_tp.allotment == tp.allotment
                    and session.planner._factors_key(tp.allotment,
                                                     old_shares)
                    == session.planner._factors_key(tp.allotment,
                                                    new_shares)):
                new_sessions[name] = session.sessions[name]
                continue
            sess = session._arm_tenant(
                tp, state=session._local_state(tp, session.state))
            stall = 0.0
            if old_tp is not None:
                old_current = session.sessions[name].current
                if (_orig_placement(old_current, old_tp)
                        != _orig_placement(sess.current, tp)):
                    # prestaged: drain only, no weight load
                    stall = sess.adapter.config.switch_drain_s
            sess.current.meta["switch_stall_s"] = stall
            sess.current.meta["fleet"] = list(tp.allotment)
            sess.current.meta["fallback"] = True
            new_sessions[name] = sess
            actions.append(TenantAction(
                tenant=name, action="fallback", react_s=0.0, stall_s=stall,
                latency_after=sess.current.latency, allotment=tp.allotment))
        session.plan = new_plan
        session.sessions = new_sessions
        session.active = tuple(sorted(
            set(session.active) - frozenset(lost)))
        session.rebalances += 1
        return actions
