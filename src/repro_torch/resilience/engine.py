# A copy of src/repro/resilience/engine.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's chaos traces must match the reference's event for event.
"""Chaos serving engine: detection-latency-aware serving under faults.

The plain serving kernel treats every dynamics event as *announced*:
the session reacts at the event's timestamp and no request ever fails.
This engine runs the same open-loop admission model under
**unannounced** faults with honest failure semantics:

* **Ground truth vs. belief.** Fault onsets mutate ground truth only
  (a crashed device, a dead link, a silently-slowed straggler); the
  session's *believed* state is untouched until detection. Requests
  served during a silent slowdown pay the true (slower) latency; a
  plan whose route crosses a dead link or crashed device is broken.
* **Detection latency.** Crashes are detected by pumping a real
  :class:`~repro_torch.runtime.heartbeat.Coordinator` over the beat grid —
  only crashed devices stop beating, so a crash at ``t`` is acted on
  at the first tick past ``t + miss_limit * beat_interval``. Link and
  straggler onsets are debounced by the same window.
* **Failure modes.** ``blind`` (broken, not yet detected): admitted
  requests wait out the per-request timeout, then fail and retry.
  ``down`` (detected, but no servable plan): requests fail fast and
  retry with capped exponential backoff. ``brownout`` (plan exists but
  QoE-infeasible): batch-class admissions are shed, interactive ones
  keep serving. Fault onset also *retro-fails* every booked-but-
  unfinished request — the pipeline's in-flight state is lost, and the
  energy already booked for them stays booked (work the fault wasted).
* **Recovery.** ``recovery="ladder"`` switches instantly to the
  precomputed :class:`~repro_torch.resilience.ladder.FallbackLadder` entry
  (stall = pipeline drain only; weights are prestaged) and rebuilds
  the ladder in the background; ``recovery="replan"`` is naive
  replan-on-detect — planning time lands on the critical path and the
  switch pays the synchronous (no async prefetch overlap: the old
  pipeline is dead) load stall. Static strategies never recover;
  their requests stay blind until the fault's announced repair.
* **MTTR.** Each service-affecting fault records onset, detection and
  restore times; ``ServingTrace.mttr_s`` is the mean onset→restored
  gap over restored faults.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.adapter import DynamicsEvent
from ..core import events as kernel
from ..core.events import AdapterAction, RequestLog, ServingTrace
from ..runtime.heartbeat import Coordinator
from .faults import ResilienceConfig
from .ladder import FallbackLadder, FleetLadder

__all__ = ["ResilientStream", "plan_link_resources", "run_chaos",
           "run_chaos_fleet"]


def plan_link_resources(plan, fleet, topo) -> frozenset:
    """Link resource names a plan's traffic traverses, in original
    topology space: consecutive-stage pairs (activations) plus
    intra-stage pairs (TP/DP sync). A fault on any of these breaks the
    pipeline outright — it is not a repricing."""
    idx = list(fleet)
    used: Set[str] = set()
    stages = plan.stages
    for i, s in enumerate(stages):
        devs = [idx[d] for d in s.devices]
        for a_pos, a in enumerate(devs):
            for b in devs[a_pos + 1:]:
                used.update(r.name for r in topo.resources_between(a, b))
        if i + 1 < len(stages):
            for a in devs:
                for b in (idx[d] for d in stages[i + 1].devices):
                    if a != b:
                        used.update(
                            r.name for r in topo.resources_between(a, b))
    return frozenset(used)


class ResilientStream:
    """Per-request admission queue with failure modes and retries.

    The heap holds ``(issue_t, seq, request, attempt)`` — arrivals and
    re-queued retries interleave in time order. Unlike the vectorized
    ``Stream`` this steps per request (chaos runs are event-dense; the
    no-fault path never comes through here, so kernel parity is
    untouched)."""

    def __init__(self, arrivals, plan, *, policy, slo_s: float,
                 classes=(), class_id=None):
        self.arrival = np.ascontiguousarray(arrivals, dtype=np.float64)
        n = len(self.arrival)
        self.start = self.arrival.copy()
        self.finish = np.full(n, math.inf)
        self.attempts = np.zeros(n, dtype=np.int64)
        self.hedged = np.zeros(n, dtype=bool)
        self.classes = tuple(classes)
        self.class_id = class_id
        self.policy = policy
        self.timeout = policy.resolve_timeout(
            slo_s, plan.latency if plan is not None else slo_s)
        self.plan = plan
        self.mode = "ok"                 # ok | blind | down | brownout
        self.next_free = 0.0
        self.service_energy: Dict[int, float] = {}
        self.busy: Dict[int, float] = {}
        self._open: List[Tuple[int, float, float]] = []  # (idx, issued, fin)
        self._seq = n
        self._heap = [(float(a), i, i, 1) for i, a in enumerate(self.arrival)]
        heapq.heapify(self._heap)

    def _class_name(self, idx: int) -> str:
        if self.class_id is None or not self.classes:
            return ""
        return self.classes[int(self.class_id[idx])].name

    def serve_to(self, t: float) -> None:
        while self._heap and self._heap[0][0] < t:
            at, _, idx, attempt = heapq.heappop(self._heap)
            self._issue(at, idx, attempt)

    def drain(self) -> None:
        while self._heap:
            at, _, idx, attempt = heapq.heappop(self._heap)
            self._issue(at, idx, attempt)

    def _issue(self, at: float, idx: int, attempt: int) -> None:
        self.attempts[idx] = attempt
        if self.mode == "down" or self.plan is None:
            # detected outage with nothing servable: fail fast, back off
            self._requeue(idx, attempt, at)
            return
        if self.mode == "blind":
            # broken but undetected: the client waits out its timeout
            self._requeue(idx, attempt, at + self.timeout)
            return
        if self.mode == "brownout" and self._class_name(idx) == "batch":
            self.finish[idx] = math.inf      # shed, not retried
            return
        p = self.plan
        start = max(at, self.next_free)
        self.start[idx] = start
        self.finish[idx] = start + p.latency
        self.next_free = start + p.interval
        for d, e in p.non_idle_energy.items():
            self.service_energy[d] = self.service_energy.get(d, 0.0) + e
        for d, b in p.compute_busy.items():
            self.busy[d] = self.busy.get(d, 0.0) + b
        self._open.append((idx, at, self.finish[idx]))

    def _requeue(self, idx: int, attempt: int, fail_t: float) -> None:
        """Attempt failed, noticed at ``fail_t``; re-queue per policy."""
        self.finish[idx] = math.inf
        if attempt > self.policy.max_retries:
            return
        hedge = (self.policy.hedge
                 and self._class_name(idx) == "interactive")
        delay = 0.0 if hedge else self.policy.backoff(attempt + 1)
        if hedge:
            self.hedged[idx] = True
        self._seq += 1
        heapq.heappush(self._heap,
                       (fail_t + delay, self._seq, idx, attempt + 1))

    def break_pipeline(self, t: float) -> None:
        """Fault onset: in-flight state is lost, so every booked-but-
        unfinished request fails. The client notices at its timeout
        (or at ``t`` if that already passed); energy booked for the
        lost work stays booked."""
        pending, self._open = self._open, []
        for idx, issued, fin in pending:
            if fin <= t:
                continue
            self._requeue(idx, int(self.attempts[idx]),
                          max(t, issued + self.timeout))

    def stall(self, t: float, stall_s: float) -> None:
        if stall_s > 0.0:
            self.next_free = max(self.next_free, t) + stall_s

    def last_finite_finish(self) -> float:
        fin = self.finish[np.isfinite(self.finish)]
        return float(fin.max()) if len(fin) else 0.0


# -- fault occurrence bookkeeping ----------------------------------------------
def _new_record(kind: str, target, t: float, factor=None) -> Dict[str, object]:
    rec: Dict[str, object] = {
        "kind": kind, "target": target, "t": float(t),
        "detect_t": None, "restore_t": None, "mttr_s": None,
        "affected": False, "restored": False}
    if factor is not None:
        rec["factor"] = float(factor)
    return rec


def _crash_spans(occurrences, announced) -> Dict[int, List[Tuple[float, float]]]:
    """Per-device crash intervals ``[onset, repair)`` — a crash is
    repaired by an *announced* join (the rebooted device says hello)."""
    spans: Dict[int, List[Tuple[float, float]]] = {}
    open_: Dict[int, float] = {}
    items = sorted(
        [(rec["t"], 0, rec["target"]) for rec in occurrences
         if rec["kind"] == "crash"]
        + [(ev.t, 1, d) for _, ev in announced for d in ev.join],
        key=lambda x: (x[0], x[1]))
    for t, phase, d in items:
        if phase == 0:
            open_.setdefault(d, t)
        elif d in open_:
            spans.setdefault(d, []).append((open_.pop(d), t))
    for d, t in open_.items():
        spans.setdefault(d, []).append((t, math.inf))
    return spans


def _detect_crashes(n_devices: int, spans, t_end: float,
                    config: ResilienceConfig) -> Dict[Tuple[int, float], float]:
    """Pump a real Coordinator over the beat grid: only crashed devices
    stop beating, so detection lands at the first tick past
    ``onset + miss_limit * beat_interval``. Returns
    ``{(device, onset): detect_t}``."""
    coord = Coordinator(list(range(n_devices)),
                        beat_interval=config.beat_interval,
                        miss_limit=config.miss_limit)

    def down_at(d: int, t: float) -> bool:
        return any(o <= t < r for o, r in spans.get(d, ()))

    detects: Dict[Tuple[int, float], float] = {}
    last = t_end + config.detection_window_s + 2.0 * config.beat_interval
    k = 1
    t = config.beat_interval
    while t <= last:
        for d in range(n_devices):
            if not down_at(d, t):
                coord.beat(d, t)
        for d in coord.tick(t):
            onsets = [o for o, r in spans.get(d, ()) if o <= t < r]
            if onsets:
                detects[(d, max(onsets))] = t
        k += 1
        t = k * config.beat_interval
    return detects


def _expand_faults(timeline, config: ResilienceConfig):
    """Split a labeled timeline into announced events and individual
    fault occurrences, then schedule each occurrence's detection.

    Returns ``(announced, entries)`` where ``entries`` is the merged,
    time-ordered list of ``(t, prio, seq, kind, payload)`` the engine
    replays: fault onsets (prio 0), announced events (prio 1) and
    detections (prio 2)."""
    announced: List[Tuple[str, DynamicsEvent]] = []
    occurrences: List[Dict[str, object]] = []
    recoveries: List[Dict[str, object]] = []
    for label, ev in timeline:
        if ev.is_fault:
            for d in ev.crash:
                occurrences.append(_new_record("crash", int(d), ev.t))
            for r in ev.link_down:
                occurrences.append(_new_record("link_down", r, ev.t))
            for r in ev.link_up:
                recoveries.append(_new_record("link_up", r, ev.t))
            for d, f in sorted(ev.straggler.items()):
                if f == 1.0:
                    recoveries.append(
                        _new_record("straggler_recover", int(d), ev.t,
                                    factor=1.0))
                else:
                    occurrences.append(
                        _new_record("straggler", int(d), ev.t, factor=f))
        if ev.is_announced:
            announced.append((label if not ev.is_fault
                              else f"event@t={ev.t:g}s",
                              dataclasses.replace(ev, crash=(),
                                                  link_down=(), link_up=(),
                                                  straggler={})))
    return announced, occurrences, recoveries


def _build_entries(announced, occurrences, recoveries, detects,
                   config: ResilienceConfig):
    entries = []
    seq = 0
    for rec in occurrences + recoveries:
        entries.append((rec["t"], 0, seq, "onset", rec))
        seq += 1
        if rec["kind"] == "crash":
            dt = detects.get((rec["target"], rec["t"]))
        else:
            dt = rec["t"] + config.detection_window_s
        if dt is not None:
            entries.append((dt, 2, seq, "detect", rec))
            seq += 1
    for label, ev in announced:
        entries.append((ev.t, 1, seq, "announced", (label, ev)))
        seq += 1
    entries.sort(key=lambda e: (e[0], e[1], e[2]))
    return entries


def _describe(prefix: str, rec: Dict[str, object]) -> str:
    k, tgt = rec["kind"], rec["target"]
    if k == "crash":
        body = f"crash: device {tgt}"
    elif k == "link_down":
        body = f"link down: {tgt}"
    elif k == "link_up":
        body = f"link up: {tgt}"
    elif k == "straggler_recover":
        body = f"straggler recovered: {tgt}"
    else:
        body = f"straggler: {tgt}->x{format(rec.get('factor', 0.5), '.3g')}"
    return f"{prefix}{body}"


def _mean_mttr(fault_log) -> Optional[float]:
    vals = [rec["mttr_s"] for rec in fault_log
            if rec.get("mttr_s") is not None]
    return float(np.mean(vals)) if vals else None


# -- single-tenant engine ------------------------------------------------------
def run_chaos(*, sc, strategy: str, session, report, scheduler, load,
              slo: float, arr, timeline, config: ResilienceConfig,
              recovery: str = "ladder") -> ServingTrace:
    """Delegate target of ``simulate_requests`` whenever fault content
    is present. ``session``/``report``/``scheduler`` arrive pre-armed
    exactly as the plain path builds them."""
    if recovery not in ("ladder", "replan", "none"):
        raise ValueError(f"unknown recovery mode {recovery!r}")
    topo = report.topology
    announced, occurrences, recoveries = _expand_faults(timeline, config)
    spans = _crash_spans(occurrences, announced)
    t_end = max([0.0, float(arr[-1]) if len(arr) else 0.0,
                 *(ev.t for _, ev in timeline)])
    detects = _detect_crashes(topo.n, spans, t_end, config)
    entries = _build_entries(announced, occurrences, recoveries, detects,
                             config)

    dora_mode = strategy == "dora"
    ladder = (FallbackLadder(session)
              if dora_mode and recovery == "ladder" else None)

    if dora_mode:
        plan0 = kernel.freeze_plan(session.current, session.plan_fleet, topo)
    else:
        plan0 = kernel.freeze_plan(report.best, range(topo.n), topo)
    class_id = load.sample_class_ids(len(arr))
    stream = ResilientStream(arr, plan0, policy=config.retry, slo_s=slo,
                             classes=load.classes, class_id=class_id)
    presence = kernel.PresenceTracker(topo.n)
    actions: List[AdapterAction] = []
    fault_log: List[Dict[str, object]] = []

    # ground truth (what actually happened) vs. belief (what the
    # session/static state knows)
    crashed: Set[int] = set()
    dead_links: Set[str] = set()
    true_speed: Dict[int, float] = {}
    detected_crashed: Set[int] = set()
    detected_links: Set[str] = set()
    fault_touched = False
    from ..control.plane import StaticPlane
    static = StaticPlane(topo.n, plan0.devices)

    def current_frozen():
        """The *true* active plan: the believed plan re-priced under
        silent straggler truth (bit-identical freeze when no silent
        divergence — parity with the plain path)."""
        if dora_mode:
            if session.degraded:
                return None
            plan = session.current
            overlay = {d: f for d, f in true_speed.items()
                       if d in session.plan_fleet
                       and f != session.state.compute_speed.get(d, 1.0)}
            if overlay:
                mapping = {orig: pos
                           for pos, orig in enumerate(session.plan_fleet)}
                cond = session._translate(session.state)
                speed = dict(cond.compute_speed)
                speed.update({mapping[d]: f for d, f in overlay.items()})
                plan = session.adapter.scheduler.refine(
                    plan, compute_speed=speed,
                    bandwidth_scale=dict(cond.bandwidth_scale))
            return kernel.freeze_plan(plan, session.plan_fleet, topo)
        if not static.alive:
            return None
        speed = dict(static.state.compute_speed)
        speed.update({d: f for d, f in true_speed.items()
                      if speed.get(d, 1.0) != f})
        if speed or static.state.bandwidth_scale:
            plan = scheduler.evaluate_fair(
                report.best, compute_speed=speed,
                bandwidth_scale=dict(static.state.bandwidth_scale))
        else:
            plan = report.best
        return kernel.freeze_plan(plan, range(topo.n), topo)

    def route_links() -> frozenset:
        if dora_mode:
            if session.degraded:
                return frozenset()
            return plan_link_resources(session.current, session.plan_fleet,
                                       topo)
        return plan_link_resources(report.best, range(topo.n), topo)

    def refresh() -> None:
        frozen = current_frozen()
        if frozen is None:
            stream.plan = None
            stream.mode = "down" if dora_mode else "blind"
            return
        stream.plan = frozen
        broken_devs = set(frozen.devices) & crashed
        broken_links = route_links() & dead_links
        if broken_devs or broken_links:
            if not dora_mode:
                stream.mode = "blind"    # static never reroutes
            elif (broken_devs - detected_crashed) \
                    or (broken_links - detected_links):
                stream.mode = "blind"
            else:
                stream.mode = "down"
        elif dora_mode and fault_touched and not session.meets_qoe:
            stream.mode = "brownout"
        else:
            stream.mode = "ok"

    def close_restored(t: float, extra: float) -> None:
        if stream.mode not in ("ok", "brownout"):
            return
        for rec in fault_log:
            if (rec["affected"] and not rec["restored"]
                    and rec["kind"] in ("crash", "link_down")
                    and rec["t"] <= t):
                rec["restored"] = True
                rec["restore_t"] = t + extra
                rec["mttr_s"] = t + extra - rec["t"]

    def lat_now() -> float:
        return (stream.plan.latency
                if stream.plan is not None
                and stream.mode in ("ok", "brownout") else math.inf)

    for t, prio, _seq, kind, payload in entries:
        stream.serve_to(t)
        if kind == "onset":
            rec = payload
            k, tgt = rec["kind"], rec["target"]
            fault_touched = fault_touched or k in ("crash", "link_down",
                                                   "straggler")
            frozen = current_frozen()
            devs = set(frozen.devices) if frozen is not None else set()
            links = route_links()
            if k == "crash":
                crashed.add(tgt)
                presence.apply(DynamicsEvent(t=t, leave=(tgt,)))
                rec["affected"] = tgt in devs
            elif k == "link_down":
                dead_links.add(tgt)
                rec["affected"] = tgt in links
            elif k == "link_up":
                dead_links.discard(tgt)
            elif k == "straggler":
                true_speed[tgt] = rec["factor"]
                rec["affected"] = tgt in devs
            else:                        # straggler_recover
                true_speed[tgt] = 1.0
            if k in ("crash", "link_down", "straggler"):
                fault_log.append(rec)
            if rec["affected"] and k in ("crash", "link_down"):
                stream.break_pipeline(t)
            refresh()
            actions.append(AdapterAction(
                t=t, label=_describe("", rec), action="unobserved",
                react_s=0.0, stall_s=0.0, latency_after=lat_now()))
            close_restored(t, 0.0)       # a link_up can restore silently
            continue
        if kind == "announced":
            label, ev = payload
            presence.apply(ev)
            for d in ev.join:            # a rejoin repairs a crash
                if d in crashed:
                    crashed.discard(d)
                    detected_crashed.discard(d)
            react = stall = 0.0
            if dora_mode:
                new, act, react = session.on_dynamics(ev)
                stall = (float(new.meta.get("switch_stall_s", 0.0))
                         if act == "replan" else 0.0)
                stream.stall(t, stall)
                if ladder is not None and act == "replan":
                    ladder.build()       # fleet changed: refresh scopes
            else:
                t0 = time.perf_counter()
                act = "repriced" if static.apply(ev) else "degraded"
                react = time.perf_counter() - t0
            refresh()
            actions.append(AdapterAction(
                t=t, label=label, action=act, react_s=react, stall_s=stall,
                latency_after=lat_now()))
            close_restored(t, stall)
            continue
        # detection
        rec = payload
        k, tgt = rec["kind"], rec["target"]
        if k == "crash" and tgt not in crashed:
            continue                     # repaired before detection
        rec["detect_t"] = t
        if k == "crash":
            detected_crashed.add(tgt)
        elif k == "link_down":
            detected_links.add(tgt)
        elif k == "link_up":
            detected_links.discard(tgt)
        was_broken = stream.mode in ("blind", "down")
        if dora_mode and recovery != "none":
            # detection-time recovery is the control plane's job
            act, react, stall = session.plane.on_detection(
                rec, config=config, ladder=ladder)
            if act not in ("degraded", "unobserved") \
                    and not session.meets_qoe:
                act = "brownout"         # adopted, but QoE-infeasible
            # recovery planning lands on the critical path only when
            # the pipeline was actually out
            stream.stall(t, react + stall if was_broken else stall)
        else:
            act, react, stall = ("degraded" if was_broken
                                 else "unobserved"), 0.0, 0.0
        if k in ("straggler", "straggler_recover") and rec.get("affected"):
            rec["restored"] = True
            rec["restore_t"] = t + react
            rec["mttr_s"] = t + react - rec["t"]
        refresh()
        actions.append(AdapterAction(
            t=t, label=_describe("detected ", rec), action=act,
            react_s=react, stall_s=stall, latency_after=lat_now()))
        close_restored(t, react + stall)

    stream.drain()

    horizon = max([0.0, float(arr[-1]) if len(arr) else 0.0,
                   stream.last_finite_finish(),
                   *(e[0] for e in entries)])
    idle_s = presence.seconds(horizon)
    per_device_energy: Dict[int, float] = {}
    for d, dev in enumerate(topo.devices):
        per_device_energy[d] = stream.service_energy.get(d, 0.0) \
            + dev.p_idle * idle_s.get(d, 0.0)

    log = RequestLog(stream.arrival, stream.start, stream.finish,
                     class_id=class_id, classes=load.classes,
                     attempts=stream.attempts, hedged=stream.hedged)
    return ServingTrace(scenario=sc.name, strategy=strategy, load=load,
                        slo_s=slo, requests=log, actions=actions,
                        per_device_energy=per_device_energy,
                        per_device_busy=dict(stream.busy),
                        horizon_s=float(horizon),
                        per_device_idle_s=idle_s,
                        faults=fault_log, mttr_s=_mean_mttr(fault_log))


# -- fleet engine --------------------------------------------------------------
def run_chaos_fleet(*, fs, session, loads, timeline,
                    config: ResilienceConfig, recovery: str = "ladder"):
    """Multi-tenant chaos run: delegate target of ``simulate_fleet``
    when fault content is present. Mirrors its energy/ownership
    attribution with per-tenant :class:`ResilientStream`\\ s."""
    from ..sim.fleet import FleetAction

    if recovery not in ("ladder", "replan", "none"):
        raise ValueError(f"unknown recovery mode {recovery!r}")
    topo = session.planner.topo
    announced, occurrences, recoveries = _expand_faults(timeline, config)
    spans = _crash_spans(occurrences, announced)
    names = [t.name for t in fs.tenants]
    arrivals = {n: loads[n].sample_arrivals() for n in names}
    class_ids = {n: loads[n].sample_class_ids(len(arrivals[n]))
                 for n in names}
    t_end = max([0.0, *(float(a[-1]) for a in arrivals.values() if len(a)),
                 *(ev.t for _, ev in timeline)])
    detects = _detect_crashes(topo.n, spans, t_end, config)
    entries = _build_entries(announced, occurrences, recoveries, detects,
                             config)
    ladder = FleetLadder(session) if recovery == "ladder" else None

    # ground truth vs believed state (see run_chaos)
    crashed: Set[int] = set()
    dead_links: Set[str] = set()
    true_speed: Dict[int, float] = {}
    detected_crashed: Set[int] = set()
    detected_links: Set[str] = set()
    fault_touched = False
    rebalance_stuck = False              # naive replan hit a dead end

    def freeze(name: str):
        tp = session.plan.tenants.get(name)
        sess = session.sessions.get(name)
        if tp is None or sess is None:
            return None
        plan = sess.current
        overlay = {tp.mapping[d]: f for d, f in true_speed.items()
                   if d in tp.mapping
                   and sess.state.compute_speed.get(tp.mapping[d], 1.0) != f}
        if overlay:
            speed = dict(sess.state.compute_speed)
            speed.update(overlay)
            plan = sess.adapter.scheduler.refine(
                plan, compute_speed=speed,
                bandwidth_scale=dict(sess.state.bandwidth_scale))
        return kernel.freeze_plan(plan, tp.allotment, topo)

    slos = {}
    for tn in fs.tenants:
        load = loads[tn.name]
        slos[tn.name] = (load.slo_s if load.slo_s is not None
                         else tn.qoe.t_qoe)
    streams: Dict[str, ResilientStream] = {}
    for tn in fs.tenants:
        streams[tn.name] = ResilientStream(
            arrivals[tn.name], freeze(tn.name), policy=config.retry,
            slo_s=slos[tn.name], classes=loads[tn.name].classes,
            class_id=class_ids[tn.name])
    presence = kernel.PresenceTracker(topo.n)
    ownership = kernel.OwnershipTracker(session.plan.assignments)
    rows: List[FleetAction] = []
    fault_log: List[Dict[str, object]] = []

    def tenant_route(name: str) -> frozenset:
        tp = session.plan.tenants.get(name)
        sess = session.sessions.get(name)
        if tp is None or sess is None:
            return frozenset()
        return plan_link_resources(sess.current, tp.allotment, topo)

    def refresh() -> None:
        for name, stream in streams.items():
            frozen = freeze(name)
            tp = session.plan.tenants.get(name)
            if frozen is None or tp is None:
                stream.plan = None
                stream.mode = "down"
                continue
            stream.plan = frozen
            broken_devs = set(tp.allotment) & crashed
            broken_links = tenant_route(name) & dead_links
            if broken_devs or broken_links:
                if (broken_devs - detected_crashed) \
                        or (broken_links - detected_links):
                    stream.mode = "blind"
                else:
                    stream.mode = "down"
            elif fault_touched and not session.sessions[name].meets_qoe:
                stream.mode = "brownout"
            else:
                stream.mode = "ok"

    def all_serving() -> bool:
        return all(s.mode in ("ok", "brownout") for s in streams.values())

    def close_restored(t: float, extra: float) -> None:
        if not all_serving():
            return
        for rec in fault_log:
            if (rec["affected"] and not rec["restored"]
                    and rec["kind"] in ("crash", "link_down")
                    and rec["t"] <= t):
                rec["restored"] = True
                rec["restore_t"] = t + extra
                rec["mttr_s"] = t + extra - rec["t"]

    def dispatch(t: float, label: str, ev: DynamicsEvent,
                 *, critical: bool, extra_stall: float = 0.0) -> float:
        """Feed one believed event through the FleetSession; book the
        tenant stalls (+planning time when ``critical``). Returns the
        worst stall booked."""
        nonlocal rebalance_stuck
        t0 = time.perf_counter()
        try:
            reacted = session.on_dynamics(ev)
            rebalance_stuck = False
        except (ValueError, RuntimeError):
            # not enough devices / disconnected: the affected tenants
            # stay down until an announced rejoin
            rebalance_stuck = True
            reacted = []
        react = time.perf_counter() - t0
        worst = 0.0
        for a in reacted:
            stall = a.stall_s + extra_stall
            if a.tenant in streams:
                streams[a.tenant].stall(
                    t, (react + stall) if critical else stall)
            worst = max(worst, stall)
            rows.append(FleetAction(
                t=t, label=label, tenant=a.tenant, action=a.action,
                react_s=react, stall_s=stall,
                latency_after=a.latency_after, allotment=a.allotment))
        ownership.update(t, session.plan.assignments)
        return react + worst

    for t, prio, _seq, kind, payload in entries:
        for s in streams.values():
            s.serve_to(t)
        if kind == "onset":
            rec = payload
            k, tgt = rec["kind"], rec["target"]
            fault_touched = fault_touched or k in ("crash", "link_down",
                                                   "straggler")
            if k == "crash":
                crashed.add(tgt)
                presence.apply(DynamicsEvent(t=t, leave=(tgt,)))
                rec["affected"] = any(
                    tgt in tp.allotment
                    for tp in session.plan.tenants.values())
            elif k == "link_down":
                dead_links.add(tgt)
                rec["affected"] = any(tgt in tenant_route(n) for n in names)
            elif k == "link_up":
                dead_links.discard(tgt)
            elif k == "straggler":
                true_speed[tgt] = rec["factor"]
                rec["affected"] = any(
                    tgt in tp.allotment
                    for tp in session.plan.tenants.values())
            else:
                true_speed[tgt] = 1.0
            if k in ("crash", "link_down", "straggler"):
                fault_log.append(rec)
            if rec["affected"] and k in ("crash", "link_down"):
                for name, stream in streams.items():
                    tp = session.plan.tenants.get(name)
                    if tp is None:
                        continue
                    if (k == "crash" and tgt in tp.allotment) or \
                            (k == "link_down" and tgt in tenant_route(name)):
                        stream.break_pipeline(t)
            refresh()
            rows.append(FleetAction(
                t=t, label=_describe("", rec), tenant="*",
                action="unobserved", react_s=0.0, stall_s=0.0,
                latency_after=math.nan, allotment=tuple(session.active)))
            close_restored(t, 0.0)
            continue
        if kind == "announced":
            label, ev = payload
            presence.apply(ev)
            for d in ev.join:
                if d in crashed:
                    crashed.discard(d)
                    detected_crashed.discard(d)
            extra = dispatch(t, label, ev, critical=False)
            refresh()
            close_restored(t, extra)
            continue
        rec = payload
        k, tgt = rec["kind"], rec["target"]
        if k == "crash" and tgt not in crashed:
            continue
        rec["detect_t"] = t
        if k == "crash":
            detected_crashed.add(tgt)
        elif k == "link_down":
            detected_links.add(tgt)
        elif k == "link_up":
            detected_links.discard(tgt)
        extra = 0.0
        if recovery != "none":
            if k == "crash" and tgt in session.active:
                handled = False
                if ladder is not None:
                    t0 = time.perf_counter()
                    acts = ladder.apply({tgt})
                    if acts is not None:
                        react = time.perf_counter() - t0
                        worst = 0.0
                        for a in acts:
                            if a.tenant in streams:
                                streams[a.tenant].stall(t, react + a.stall_s)
                            worst = max(worst, a.stall_s)
                            rows.append(FleetAction(
                                t=t, label=_describe("detected ", rec),
                                tenant=a.tenant, action=a.action,
                                react_s=react, stall_s=a.stall_s,
                                latency_after=a.latency_after,
                                allotment=a.allotment))
                        ownership.update(t, session.plan.assignments)
                        ladder.build()
                        extra = react + worst
                        handled = True
                if not handled:
                    # naive replan-on-detect: tenants on the dead device
                    # can't overlap the weight prefetch with serving,
                    # nor stream ahead of the switch
                    from ..core.adapter import AdapterConfig
                    prev_cfg = session.planner.adapter_config
                    cfg = dataclasses.replace(prev_cfg or AdapterConfig(),
                                              async_switching=False,
                                              streamed_migration=False)
                    session.planner.adapter_config = cfg
                    try:
                        extra = dispatch(
                            t, _describe("detected ", rec),
                            DynamicsEvent(t=t, leave=(tgt,)), critical=True)
                    finally:
                        session.planner.adapter_config = prev_cfg
                    if ladder is not None:
                        ladder.build()
            elif k in ("link_down", "link_up"):
                scale = (config.link_down_scale if k == "link_down" else 1.0)
                extra = dispatch(t, _describe("detected ", rec),
                                 DynamicsEvent(t=t,
                                               bandwidth_scale={tgt: scale}),
                                 critical=False)
            elif k in ("straggler", "straggler_recover"):
                extra = dispatch(
                    t, _describe("detected ", rec),
                    DynamicsEvent(t=t,
                                  compute_speed={tgt: rec.get("factor",
                                                              1.0)}),
                    critical=False)
        if k in ("straggler", "straggler_recover") and rec.get("affected"):
            rec["restored"] = True
            rec["restore_t"] = t
            rec["mttr_s"] = t - rec["t"]
        refresh()
        close_restored(t, extra)

    for s in streams.values():
        s.drain()

    # -- trace assembly: mirrors ``simulate_fleet``'s energy/ownership
    # attribution (idle draw once per device over its presence interval,
    # prorated across owning tenants; service energy to the admitter)
    from collections import OrderedDict
    from ..sim.fleet import FleetTrace

    horizon = max([0.0,
                   *(float(a[-1]) for a in arrivals.values() if len(a)),
                   *(s.last_finite_finish() for s in streams.values()),
                   *(e[0] for e in entries)])
    presence_iv = presence.intervals(horizon)
    fleet_idle = presence.seconds(horizon)
    fleet_energy: Dict[int, float] = {
        d: dev.p_idle * fleet_idle.get(d, 0.0)
        for d, dev in enumerate(topo.devices)}
    tenant_idle: Dict[str, Dict[int, float]] = {n: {} for n in names}
    for d, span_list in ownership.spans(horizon).items():
        for lo, hi, owner in span_list:
            if owner not in tenant_idle:
                continue
            secs = kernel.overlap_seconds(presence_iv.get(d, ()), lo, hi)
            if secs > 0.0:
                tenant_idle[owner][d] = tenant_idle[owner].get(d, 0.0) + secs

    traces: "OrderedDict[str, ServingTrace]" = OrderedDict()
    fleet_busy: Dict[int, float] = {}
    for tn in fs.tenants:
        name = tn.name
        stream = streams[name]
        for d, e in stream.service_energy.items():
            fleet_energy[d] = fleet_energy.get(d, 0.0) + e
        for d, b in stream.busy.items():
            fleet_busy[d] = fleet_busy.get(d, 0.0) + b
        tenant_energy = dict(stream.service_energy)
        idle_secs = tenant_idle[name]
        for d, secs in idle_secs.items():
            tenant_energy[d] = tenant_energy.get(d, 0.0) \
                + topo.devices[d].p_idle * secs
        log = RequestLog(stream.arrival, stream.start, stream.finish,
                         class_id=class_ids[name],
                         classes=loads[name].classes,
                         attempts=stream.attempts, hedged=stream.hedged)
        traces[name] = ServingTrace(
            scenario=f"{fs.name}/{name}", strategy="fleet",
            load=loads[name], slo_s=slos[name], requests=log,
            actions=[AdapterAction(t=a.t, label=a.label, action=a.action,
                                   react_s=a.react_s, stall_s=a.stall_s,
                                   latency_after=a.latency_after)
                     for a in rows if a.tenant == name],
            per_device_energy=tenant_energy,
            per_device_busy=dict(stream.busy),
            horizon_s=float(horizon),
            per_device_idle_s=idle_secs)

    return FleetTrace(
        fleet=fs.name, tenants=traces, actions=rows,
        assignments={k: tuple(v)
                     for k, v in session.plan.assignments.items()},
        per_device_energy=fleet_energy, per_device_busy=fleet_busy,
        horizon_s=float(horizon), rebalances=session.rebalances,
        ownership=ownership.history, faults=fault_log,
        mttr_s=_mean_mttr(fault_log))
