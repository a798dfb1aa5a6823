# A copy of src/repro/core/adapter.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Phase 3 — runtime adapter (§4.3).

Two deployment-driven paths:

* **Interruptible workloads** (training/tuning): the *uniform-progress*
  heuristic amortizes the deadline over horizons
  (``EP_Δ = (Δ/D_rem)·W_rem``) and a small LP (Eqs. 7-8) picks a mixture
  of Pareto-optimal plans that meets the horizon's progress at minimum
  energy. Deficits from transient slowdowns are re-absorbed because the
  next horizon recomputes ``W_rem/D_rem``.
* **Continuous workloads** (serving): fluctuations below a threshold are
  absorbed by re-running only the Phase-2 network scheduler (sub-second,
  no model-state migration); larger shifts trigger replanning with
  **asynchronous** (prefetch immutable weights during execution) and
  **delta** (transfer only missing layers) switching.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linprog

from .device import Topology
from .plans import ParallelismPlan
from .qoe import QoESpec
from .scheduler import NetworkScheduler


# -- dynamics events ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DynamicsEvent:
    """A runtime condition change at ``t`` (seconds).

    ``compute_speed``/``bandwidth_scale`` are *absolute* multipliers vs
    nominal (0.5 = half speed), keyed by device index / resource name.
    ``leave``/``join`` are fleet churn: device indices (of the original
    deployment topology) that drop out of or rejoin the fleet at ``t``.
    Churn always forces a full replan — the plan's device set changed.

    The remaining fields are **unannounced faults** — ground-truth
    changes the runtime cannot observe at ``t`` and only acts on once
    the heartbeat detector notices (``miss_limit × beat_interval``
    later; see ``repro_torch.resilience``):

    * ``crash`` — devices that stop silently (no leave announcement,
      no further heartbeats); repair is announced via a later ``join``.
    * ``link_down``/``link_up`` — link resources (by name) that go dark
      / come back; requests routed over a dark link fail.
    * ``straggler`` — silent per-device slowdown factors: the device
      keeps heartbeating nominal numbers while actually serving slower.

    Fault fields never contribute to :meth:`magnitude` — they are
    invisible to the announced-event adapter path by construction.
    """

    t: float
    compute_speed: Dict[str, float] = dataclasses.field(default_factory=dict)
    bandwidth_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    leave: Tuple[int, ...] = ()
    join: Tuple[int, ...] = ()
    crash: Tuple[int, ...] = ()
    link_down: Tuple[str, ...] = ()
    link_up: Tuple[str, ...] = ()
    straggler: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def is_churn(self) -> bool:
        return bool(self.leave or self.join)

    @property
    def is_fault(self) -> bool:
        """True when the event carries unannounced fault content."""
        return bool(self.crash or self.link_down or self.link_up
                    or self.straggler)

    @property
    def is_announced(self) -> bool:
        """True when the event carries content the runtime can see at
        ``t`` (condition shifts or churn announcements)."""
        return bool(self.compute_speed or self.bandwidth_scale
                    or self.is_churn)

    def magnitude(self) -> float:
        if self.is_churn:
            return math.inf
        devs = [abs(1.0 - v) for v in self.compute_speed.values()]
        bws = [abs(1.0 - v) for v in self.bandwidth_scale.values()]
        return max(devs + bws + [0.0])


@dataclasses.dataclass(frozen=True)
class RuntimeState:
    """Accumulated runtime conditions: the merge of every event so far.

    Events are deltas against *nominal*, not against each other — a
    bandwidth drop at t=10 stays in force when a compute-speed event
    arrives at t=20. ``apply`` folds one more event in;
    ``delta`` measures how far an event moves conditions from this
    accumulated state (the §4.3 fluctuation-threshold input).
    """

    compute_speed: Dict[int, float] = dataclasses.field(default_factory=dict)
    bandwidth_scale: Dict[str, float] = dataclasses.field(default_factory=dict)

    def apply(self, event: DynamicsEvent) -> "RuntimeState":
        speed = dict(self.compute_speed)
        speed.update(event.compute_speed)
        bw = dict(self.bandwidth_scale)
        bw.update(event.bandwidth_scale)
        return RuntimeState(compute_speed=speed, bandwidth_scale=bw)

    def delta(self, event: DynamicsEvent) -> float:
        """Largest shift ``event`` causes relative to this state."""
        if event.is_churn:
            return math.inf
        shifts = [abs(self.compute_speed.get(k, 1.0) - v)
                  for k, v in event.compute_speed.items()]
        shifts += [abs(self.bandwidth_scale.get(k, 1.0) - v)
                   for k, v in event.bandwidth_scale.items()]
        return max(shifts + [0.0])


@dataclasses.dataclass
class AdapterConfig:
    horizon_s: float = 60.0
    fluctuation_threshold: float = 0.10     # §5: ≤10% → network-only replan
    switch_drain_s: float = 2.0             # pipeline drain on plan switch
    async_switching: bool = True
    delta_switching: bool = True
    #: DEFER-style streamed migration: on the *synchronous* switch path
    #: (async prefetch off — e.g. recovery from a dead pipeline is
    #: priced sync), overlap the next plan's weight transfer with the
    #: current plan's remaining execution so the priced stall drops from
    #: the full reload toward the exposed (non-overlapped) remainder
    streamed_migration: bool = False
    #: fraction of the migration link's bandwidth the stream may steal
    #: from serving traffic while overlapping
    stream_bw_fraction: float = 0.5


def _plan_tiebreak(p: ParallelismPlan) -> tuple:
    """Deterministic total order over plans with equal (latency, energy):
    structural signature, independent of construction/input order."""
    return (p.n_stages, p.microbatch_size,
            tuple((tuple(s.node_ids), tuple(s.devices)) for s in p.stages))


def pareto_filter(plans: Sequence[ParallelismPlan]) -> List[ParallelismPlan]:
    """Keep plans Pareto-optimal in (latency, energy).

    Domination is strict-with-tiebreak: a plan is dropped iff some kept
    plan is no worse on both metrics and strictly better on at least
    one.  Plans fully tied on (latency, energy) keep exactly one
    deterministic representative (smallest structural signature), so the
    result never depends on input order.
    """
    ranked = sorted(plans, key=lambda p: (p.latency, p.energy, _plan_tiebreak(p)))
    out: List[ParallelismPlan] = []
    best_e = math.inf
    for p in ranked:
        # strict: any genuine energy improvement survives, ties collapse
        # onto the representative already kept at equal-or-lower latency
        if p.energy < best_e:
            out.append(p)
            best_e = p.energy
    return out


def cold_load_stall(plan: ParallelismPlan, topo: Topology,
                    config: AdapterConfig) -> float:
    """Service stall of loading ``plan`` onto a fleet with *nothing*
    resident (no surviving placement to delta-switch from): drain the
    pipeline, then stream the largest per-device parameter shard at the
    slowest involved peak bandwidth.  Shared by the single-tenant and
    fleet churn paths."""
    nbytes = max(plan.device_param_bytes().values(), default=0.0)
    bw = min((topo.peak_bandwidth(i, j)
              for i in plan.devices for j in plan.devices if i != j),
             default=math.inf)
    load_t = nbytes / bw if bw != math.inf else 0.0
    return config.switch_drain_s + load_t


class RuntimeAdapter:
    def __init__(self, plans: Sequence[ParallelismPlan], topo: Topology,
                 qoe: QoESpec, scheduler: NetworkScheduler,
                 config: Optional[AdapterConfig] = None):
        if not plans:
            raise ValueError("adapter needs at least one plan")
        self.all_plans = list(plans)
        self.plans = pareto_filter(plans)
        self.topo = topo
        self.qoe = qoe
        self.scheduler = scheduler
        self.config = config or AdapterConfig()

    # -- switching cost (§4.3 async + delta + DEFER streaming) -------------------
    def switch_cost(self, old: Optional[ParallelismPlan],
                    new: ParallelismPlan,
                    overlap_s: Optional[float] = None) -> float:
        """Seconds of *service stall* incurred by switching old→new.

        ``overlap_s`` is the execution span still ahead of the current
        plan that a streamed migration may overlap with (defaults to
        one iteration, ``old.latency``); it only matters when
        ``streamed_migration`` is armed and the switch is priced
        synchronously (``async_switching`` covers the announced path
        with its own full-prefetch overlap)."""
        if old is None or old is new:
            return 0.0
        cfg = self.config
        if cfg.delta_switching:
            old_layers = old.device_layers()
            nbytes = 0.0
            for st in new.stages:
                per_param = st.param_bytes / max(len(st.node_ids), 1)
                for d in st.devices:
                    have = old_layers.get(d, frozenset())
                    missing = [i for i in st.node_ids if i not in have]
                    nbytes = max(nbytes, len(missing) * per_param)
        else:
            nbytes = max(new.device_param_bytes().values())
        # conservative: weights stream at the slowest involved peak bandwidth
        bw = min((self.topo.peak_bandwidth(i, j)
                  for i in new.devices for j in new.devices if i != j),
                 default=math.inf)
        load_t = nbytes / bw if bw != math.inf else 0.0
        if cfg.async_switching:
            # prefetch overlaps with ongoing execution; stall is the drain
            return cfg.switch_drain_s + max(0.0, load_t - old.latency)
        if cfg.streamed_migration and bw != math.inf:
            # DEFER-style send-compute-receive overlap: while the current
            # plan keeps executing, a fraction of the link streams the
            # next plan's weights ahead; only the non-overlapped
            # remainder is exposed as stall
            overlap = old.latency if overlap_s is None else max(overlap_s,
                                                                0.0)
            shipped = overlap * bw * cfg.stream_bw_fraction
            exposed = max(0.0, nbytes - shipped) / bw
            return cfg.switch_drain_s + exposed
        return cfg.switch_drain_s + load_t

    # -- Eqs. (7)-(8): horizon mixture LP -----------------------------------------
    def mix_for_horizon(self, w_rem: float, d_rem: float,
                        current: Optional[ParallelismPlan] = None,
                        horizon: Optional[float] = None
                        ) -> List[Tuple[ParallelismPlan, float]]:
        """Fractions x_p of the horizon per plan meeting EP_Δ at min energy.

        ``w_rem`` — remaining work in iterations; ``d_rem`` — seconds to
        deadline. Returns [(plan, fraction)] with Σ fraction ≤ 1.
        """
        delta = min(horizon or self.config.horizon_s, max(d_rem, 1e-9))
        # pace to finish slightly early: switching stalls and horizon
        # rounding otherwise push completion just past the deadline
        d_eff = max(d_rem * 0.97, 1e-9)
        ep = min((delta / d_eff) * w_rem, w_rem)       # expected progress
        P = self.plans
        rate = np.array([1.0 / p.latency for p in P])            # iters/sec
        e_rate = np.array([p.energy / p.latency for p in P])     # J/sec
        d_p = np.array([self.switch_cost(current, p) for p in P])
        useful = np.maximum(delta - d_p, 0.0)
        # min Σ e_rate_p·Δ·x_p   s.t.  Σ rate_p·useful_p·x_p ≥ EP,  Σ x_p ≤ 1
        c = e_rate * delta
        a_ub = np.vstack([-(rate * useful), np.ones(len(P))])
        b_ub = np.array([-ep, 1.0])
        res = linprog(c, A_ub=a_ub, b_ub=b_ub, bounds=[(0.0, 1.0)] * len(P),
                      method="highs")
        if not res.success:
            # infeasible horizon: run the fastest plan flat out; the next
            # horizon's EP_Δ recomputation absorbs the deficit (§4.3)
            fastest = int(np.argmax(rate * np.maximum(delta - d_p, 0.0)))
            return [(P[fastest], 1.0)]
        out = [(P[i], float(x)) for i, x in enumerate(res.x) if x > 1e-6]
        return out or [(P[int(np.argmax(rate))], 1.0)]

    # -- interruptible-workload simulation (Fig. 12) --------------------------------
    def run_interruptible(self, total_iters: float, deadline: float,
                          dynamics: Sequence[DynamicsEvent] = (),
                          horizon: Optional[float] = None) -> Dict[str, object]:
        """Simulate horizon-by-horizon plan mixing until the job finishes.

        Returns trace with total energy, completion time, QoE verdict.
        """
        cfg = self.config
        delta = horizon or cfg.horizon_s
        t, done, energy = 0.0, 0.0, 0.0
        stall_s, stall_energy = 0.0, 0.0
        current: Optional[ParallelismPlan] = None
        events = sorted(dynamics, key=lambda e: e.t)
        trace: List[Dict[str, float]] = []
        speed: Dict[str, float] = {}
        bw: Dict[str, float] = {}
        # streamed migration overlaps the next switch's weight transfer
        # with the execution span just completed on the current plan
        prev_exec = 0.0
        while done < total_iters and t < 10 * deadline:
            while events and events[0].t <= t:
                ev = events.pop(0)
                speed.update(ev.compute_speed)
                bw.update(ev.bandwidth_scale)
                self._refresh_plans(speed, bw)
            mixture = self.mix_for_horizon(total_iters - done, deadline - t,
                                           current, delta)
            spent = 0.0
            for plan, frac in mixture:
                span = frac * delta
                if span <= 0:
                    continue
                stall = self.switch_cost(
                    current, plan,
                    overlap_s=prev_exec if cfg.streamed_migration else None)
                # migration is not free energy-wise: every device involved
                # (old placement draining + new placement loading) keeps
                # drawing idle power while it lasts — capped at the
                # mixture slice, which is all the wall-clock this
                # component occupies
                stall_eff = min(stall, span)
                if stall_eff > 0.0:
                    involved = set(plan.devices)
                    if current is not None:
                        involved |= set(current.devices)
                    idle_w = sum(self.topo.devices[d].p_idle
                                 for d in involved)
                    stall_s += stall_eff
                    stall_energy += idle_w * stall_eff
                    energy += idle_w * stall_eff
                exec_span = max(span - stall, 0.0)
                iters = min(exec_span / plan.latency, total_iters - done)
                done += iters
                energy += (plan.energy / plan.latency) * (iters * plan.latency)
                spent += stall + iters * plan.latency
                current = plan
                prev_exec = iters * plan.latency
                trace.append(dict(t=t, plan=id(plan), frac=frac, iters=iters,
                                  lat=plan.latency, stall=stall,
                                  exec_energy=plan.energy * iters))
                if done >= total_iters:
                    break
            # advance by the true elapsed time once the job finishes
            t += delta if done < total_iters else min(spent, delta)
        return dict(energy=energy, finished_at=t, done=done,
                    met_deadline=(done >= total_iters
                                  and t <= deadline * (1.0 + 1e-3)),
                    stall_s=stall_s, stall_energy=stall_energy,
                    trace=trace)

    # -- continuous-workload path (Fig. 16) ------------------------------------------
    def on_dynamics(self, current: ParallelismPlan, event: DynamicsEvent,
                    replan_fn: Optional[Callable[[], Sequence[ParallelismPlan]]] = None,
                    state: Optional[RuntimeState] = None
                    ) -> Tuple[ParallelismPlan, str, float]:
        """React to one runtime event. Returns (plan, action, react_seconds).

        ``state`` carries the conditions accumulated from *earlier*
        events; the event is merged into it so a bandwidth drop at t=10
        is still in force when a compute-speed event arrives at t=20.
        Without ``state`` the event is taken as the complete picture
        (the legacy single-event behavior). The fluctuation threshold
        compares the event against the accumulated state, not nominal.
        (Thin adapter over :func:`repro_torch.control.plane.react_once` —
        the reaction layer lives in the control plane.)
        """
        from ..control.plane import react_once
        return react_once(self, current, event, replan_fn, state)

    def react(self, current: ParallelismPlan, conditions: RuntimeState,
              magnitude: float,
              replan_fn: Optional[Callable[[], Sequence[ParallelismPlan]]] = None
              ) -> Tuple[ParallelismPlan, str, float]:
        """Adapt to the *merged* runtime conditions.

        Small shifts (``magnitude`` ≤ threshold) re-run only the Phase-2
        scheduler on the current plan. Large shifts replan: every fresh
        candidate is priced under the merged conditions **with its
        migration stall amortized into the choice** — the stall is pure
        QoE-violation seconds spread over the requests one adaptation
        horizon serves, charged at λ like any other violation (Eq. 2).
        Keeping the (rescheduled) current plan costs no stall and wins
        whenever no candidate's gain covers its own migration; the
        returned plan's ``meta["switch_stall_s"]`` is then 0.
        """
        t0 = time.perf_counter()
        speed = dict(conditions.compute_speed)
        bwsc = dict(conditions.bandwidth_scale)
        if magnitude <= self.config.fluctuation_threshold or replan_fn is None:
            refined = self.scheduler.refine(current, compute_speed=speed,
                                            bandwidth_scale=bwsc)
            return refined, "reschedule", time.perf_counter() - t0
        # substantial shift: full replan + async/delta switch
        fresh = list(replan_fn())
        refined = [self.scheduler.refine(p, compute_speed=speed,
                                         bandwidth_scale=bwsc) for p in fresh]
        kept = self.scheduler.refine(current, compute_speed=speed,
                                     bandwidth_scale=bwsc)
        horizon = max(self.config.horizon_s, 1e-9)

        def amortized(p: ParallelismPlan, stall: float) -> float:
            return p.objective + self.qoe.lam * stall * (p.latency / horizon)

        best, best_score, best_stall = kept, amortized(kept, 0.0), 0.0
        for p in refined:
            stall = self.switch_cost(current, p)
            score = amortized(p, stall)
            if score < best_score - 1e-12:
                best, best_score, best_stall = p, score, stall
        best.meta["switch_stall_s"] = best_stall
        self.plans = pareto_filter(refined + [kept])
        return best, "replan", time.perf_counter() - t0

    # -- helpers -----------------------------------------------------------------------
    def _refresh_plans(self, speed: Dict[str, float], bw: Dict[str, float]) -> None:
        """Re-evaluate the Pareto set under current conditions (fast: the
        Phase-2 scheduler only; no repartitioning)."""
        refreshed = [self.scheduler.refine(p, compute_speed=dict(speed),
                                           bandwidth_scale=dict(bw))
                     for p in self.all_plans]
        self.plans = pareto_filter(refreshed)
