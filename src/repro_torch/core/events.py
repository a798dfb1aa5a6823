# A copy of src/repro/core/events.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""The serving kernel: one vectorized event core for every request sim.

``sim/serving.py`` (single tenant), ``sim/fleet.py`` (multi-tenant) and
the plan-level :mod:`repro_torch.core.engine` used to carry three divergent
event-processing loops that had to agree on the fluid model.  This
module is the single owner of the request-level machinery they share:

* **Arrival generation** — an arrival-process zoo
  (:class:`PoissonArrivals`, :class:`DiurnalArrivals`,
  :class:`MMPPArrivals`, :class:`FlashCrowdArrivals`,
  :class:`TraceArrivals`) plus multi-class request tiers
  (:class:`RequestClass`), both carried by :class:`ServingLoad`.
* **Admission/queueing** — :class:`Stream`: between dynamics events the
  fluid pipeline model is *closed form*, so each inter-event segment is
  processed as array ops.  With carried queue state ``f`` (the time the
  pipeline next admits), admission interval ``I`` and latency ``L``, the
  k-th arrival ``a_k`` of a segment starts at::

      start_k = I*k + max(f, cummax_j<=k(a_j - I*j))        (Lindley)
      finish_k = start_k + L
      f' = start_last + I

  which is exactly the per-request recurrence ``start = max(a, f);
  f = start + I`` unrolled — a chunk size of 1 reproduces the old
  discrete loop bit-for-bit, which the segmentation property tests
  exploit.  Discrete stepping survives only at segment boundaries:
  adapter reactions, migration stalls and churn.
* **Dynamics segmentation** — :func:`replay` drives any number of
  streams through one labeled timeline, serving every arrival strictly
  before each event's ``t`` (events at ``t <= a`` fire before ``a`` is
  admitted, matching the historical loop), then firing the adapter.
* **Energy attribution** — :class:`PresenceTracker` bills idle draw
  only over a device's presence interval (a device that leaves at ``t``
  stops drawing idle power at ``t``); :class:`OwnershipTracker`
  prorates fleet idle draw across the tenants that owned a device,
  by ownership interval, instead of billing the final owner for the
  whole horizon.

The steady-state admission interval itself comes from
:meth:`repro_torch.core.engine.ScheduleResult.admission_interval` — the same
what-if primitive the plan-level engine exposes — so all three layers
price throughput identically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .adapter import DynamicsEvent

#: Default number of requests when a load doesn't specify one.
DEFAULT_N_REQUESTS = 200

#: Hard cap on rate-segment blocks when inverting an inhomogeneous
#: process — a runaway guard, far above any real horizon.
_MAX_RATE_BLOCKS = 100_000


def _json_num(x: Optional[float]) -> Optional[float]:
    """inf/nan -> None so exports stay strict-JSON parseable."""
    if x is None or math.isinf(x) or math.isnan(x):
        return None
    return x


# -- arrival processes ---------------------------------------------------------
def poisson_arrivals(rate: float, n_requests: int, seed: int = 0) -> np.ndarray:
    """Arrival times of an open-loop Poisson process (deterministic per
    seed; gaps are standard exponentials scaled by ``1/rate``, so the
    same seed at a higher rate yields a pointwise-compressed trace)."""
    if rate <= 0.0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    if n_requests <= 0:
        raise ValueError(f"n_requests must be positive, got {n_requests}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=int(n_requests)))


def _invert_unit_process(u: np.ndarray, block_fn) -> np.ndarray:
    """Warp unit-rate Poisson positions ``u`` through a piecewise-
    constant rate curve (the standard time-change construction of an
    inhomogeneous Poisson process).

    ``block_fn(i)`` returns ``(durations, rates)`` arrays for the i-th
    block of rate segments; blocks are appended until their cumulative
    mass ``sum(d*r)`` covers ``u[-1]``.  Within a constant-rate segment
    the inversion is linear, so the mapping is exact (no grid error)
    for piecewise-constant rates.
    """
    durs: List[np.ndarray] = []
    rates: List[np.ndarray] = []
    mass = 0.0
    for i in range(_MAX_RATE_BLOCKS):
        d, r = block_fn(i)
        d = np.asarray(d, dtype=np.float64)
        r = np.asarray(r, dtype=np.float64)
        durs.append(d)
        rates.append(r)
        mass += float(np.sum(d * r))
        if mass >= u[-1]:
            break
    else:
        raise ValueError("arrival process never accumulated enough rate "
                         "mass — is the mean rate positive?")
    d = np.concatenate(durs)
    r = np.concatenate(rates)
    seg_mass = d * r
    mass0 = np.concatenate(([0.0], np.cumsum(seg_mass)))[:-1]
    t0 = np.concatenate(([0.0], np.cumsum(d)))[:-1]
    pos = r > 0.0
    # zero-rate segments carry no mass: u never lands strictly inside
    # one, so the positive segments alone cover the inversion
    mass0, t0, r = mass0[pos], t0[pos], r[pos]
    idx = np.searchsorted(mass0, u, side="right") - 1
    idx = np.clip(idx, 0, len(mass0) - 1)
    return t0[idx] + (u - mass0[idx]) / r[idx]


class ArrivalProcess:
    """Base class of the arrival zoo.  ``sample(rate, n, seed)`` returns
    ``n`` sorted non-negative arrival times; ``rate`` is the load's mean
    request rate, which modulating processes scale (so traces stay
    monotone in the load's rate, like the plain Poisson process)."""

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def _unit_positions(self, rng: np.random.Generator,
                        n_requests: int) -> np.ndarray:
        if n_requests <= 0:
            raise ValueError(f"n_requests must be positive, got {n_requests}")
        return np.cumsum(rng.exponential(1.0, size=int(n_requests)))


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process at the load's rate — the default,
    bit-identical to :func:`poisson_arrivals`."""

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        return poisson_arrivals(rate, n_requests, seed)


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay an explicit arrival trace (seconds).  Ignores the load's
    rate and seed; serves the first ``n_requests`` entries when the
    trace is longer, the whole trace when shorter."""

    times: Tuple[float, ...]

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        arr = np.sort(np.asarray(self.times, dtype=np.float64))
        if len(arr) and arr[0] < 0.0:
            raise ValueError("arrival times must be non-negative")
        if n_requests and len(arr) > n_requests:
            arr = arr[:int(n_requests)]
        return arr


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal day/night rate curve around the load's mean rate:
    ``rate(t) = rate * (1 + amplitude * sin(2*pi*(t - phase_s)/period))``.
    The sinusoid is discretized to ``steps_per_period`` constant-rate
    segments (midpoint rule) before the exact piecewise inversion."""

    period_s: float = 86_400.0
    amplitude: float = 0.8          # 0..1, peak-to-mean swing
    phase_s: float = 0.0
    steps_per_period: int = 256

    def __post_init__(self) -> None:
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], "
                             f"got {self.amplitude}")
        if self.period_s <= 0.0:
            raise ValueError(f"period_s must be positive, got {self.period_s}")

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        if rate <= 0.0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        rng = np.random.default_rng(seed)
        u = self._unit_positions(rng, n_requests)
        step = self.period_s / self.steps_per_period

        def block(i: int) -> Tuple[np.ndarray, np.ndarray]:
            mid = (np.arange(self.steps_per_period) + 0.5) * step \
                + i * self.period_s
            r = rate * (1.0 + self.amplitude * np.sin(
                2.0 * math.pi * (mid - self.phase_s) / self.period_s))
            return np.full(self.steps_per_period, step), np.maximum(r, 0.0)

        return _invert_unit_process(u, block)


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """Markov-modulated Poisson process: the rate jumps between states
    (``rate * multipliers[s]``) with exponentially distributed sojourns
    — the standard bursty-traffic model.  States cycle in order
    (2 states = the classic on/off burst process)."""

    multipliers: Tuple[float, ...] = (0.25, 4.0)
    mean_sojourn_s: Tuple[float, ...] = (300.0, 60.0)
    start_state: int = 0

    def __post_init__(self) -> None:
        if len(self.multipliers) < 2:
            raise ValueError("MMPP needs at least 2 states")
        if len(self.mean_sojourn_s) != len(self.multipliers):
            raise ValueError("multipliers and mean_sojourn_s must have "
                             "the same length")
        if min(self.multipliers) < 0.0 or max(self.multipliers) <= 0.0:
            raise ValueError("state multipliers must be non-negative with "
                             "at least one positive")
        if min(self.mean_sojourn_s) <= 0.0:
            raise ValueError("mean sojourns must be positive")

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        if rate <= 0.0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        rng = np.random.default_rng(seed)
        u = self._unit_positions(rng, n_requests)
        k = len(self.multipliers)
        mults = np.asarray(self.multipliers, dtype=np.float64)
        means = np.asarray(self.mean_sojourn_s, dtype=np.float64)
        batch = 256

        def block(i: int) -> Tuple[np.ndarray, np.ndarray]:
            states = (self.start_state + i * batch
                      + np.arange(batch)) % k
            durs = rng.exponential(1.0, size=batch) * means[states]
            return durs, rate * mults[states]

        return _invert_unit_process(u, block)


@dataclasses.dataclass(frozen=True)
class FlashCrowdArrivals(ArrivalProcess):
    """A flash crowd on top of baseline traffic: the rate ramps from the
    load's rate to ``peak_multiplier``x starting at ``t_start``, holds,
    and ramps back down.  Ramps are discretized to ``ramp_steps``
    constant-rate segments."""

    peak_multiplier: float = 8.0
    t_start: float = 60.0
    ramp_s: float = 15.0
    hold_s: float = 60.0
    ramp_steps: int = 32

    def __post_init__(self) -> None:
        if self.peak_multiplier < 1.0:
            raise ValueError("peak_multiplier must be >= 1")
        if min(self.t_start, self.ramp_s, self.hold_s) < 0.0:
            raise ValueError("t_start/ramp_s/hold_s must be non-negative")

    def sample(self, rate: float, n_requests: int,
               seed: int = 0) -> np.ndarray:
        if rate <= 0.0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        rng = np.random.default_rng(seed)
        u = self._unit_positions(rng, n_requests)
        peak = rate * self.peak_multiplier
        tail_block = max(self.t_start + 2.0 * self.ramp_s + self.hold_s,
                         1.0)

        def block(i: int) -> Tuple[np.ndarray, np.ndarray]:
            if i > 0:                       # flat baseline tail forever
                return (np.asarray([tail_block]), np.asarray([rate]))
            durs: List[float] = []
            rates: List[float] = []
            if self.t_start > 0.0:
                durs.append(self.t_start)
                rates.append(rate)
            if self.ramp_s > 0.0:
                step = self.ramp_s / self.ramp_steps
                frac = (np.arange(self.ramp_steps) + 0.5) / self.ramp_steps
                durs.extend([step] * self.ramp_steps)
                rates.extend(rate + (peak - rate) * frac)
            if self.hold_s > 0.0:
                durs.append(self.hold_s)
                rates.append(peak)
            if self.ramp_s > 0.0:
                step = self.ramp_s / self.ramp_steps
                frac = (np.arange(self.ramp_steps) + 0.5) / self.ramp_steps
                durs.extend([step] * self.ramp_steps)
                rates.extend(peak - (peak - rate) * frac)
            return np.asarray(durs), np.asarray(rates)

        return _invert_unit_process(u, block)


# -- request classes -----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One SLO tier of a multi-class load (e.g. interactive vs. batch).
    ``slo_s=None`` inherits the load/scenario default SLO; ``weight`` is
    the tier's relative share of arrivals; ``priority > 0`` marks the
    tier preemptive — with preemption armed
    (:class:`~repro_torch.control.plane.ControlConfig`) its requests jump
    queued lower-priority admissions at the bottleneck stage."""

    name: str
    slo_s: Optional[float] = None
    weight: float = 1.0
    priority: int = 0

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError(f"class weight must be positive, "
                             f"got {self.weight}")


def interactive_batch(interactive_slo: float, batch_slo: float,
                      interactive_share: float = 0.7
                      ) -> Tuple[RequestClass, RequestClass]:
    """The canonical two-tier mix: latency-sensitive interactive
    requests alongside throughput-oriented batch ones."""
    if not 0.0 < interactive_share < 1.0:
        raise ValueError("interactive_share must be in (0, 1)")
    return (RequestClass("interactive", slo_s=interactive_slo,
                         weight=interactive_share, priority=1),
            RequestClass("batch", slo_s=batch_slo,
                         weight=1.0 - interactive_share))


def assign_classes(n_requests: int, classes: Sequence[RequestClass],
                   seed: int = 0) -> np.ndarray:
    """Seeded per-request class ids (int16), weighted by class weight.
    The stream is drawn independently of the arrival process so the same
    arrivals can be re-tiered without moving in time."""
    w = np.asarray([c.weight for c in classes], dtype=np.float64)
    rng = np.random.default_rng([0xC1A55, int(seed) & 0xFFFFFFFF])
    return rng.choice(len(classes), size=int(n_requests),
                      p=w / w.sum()).astype(np.int16)


@dataclasses.dataclass(eq=False)
class PreemptionSpec:
    """Stage-level priority preemption for one :class:`Stream`.

    ``class_id`` aligns with the stream's arrivals; ``interactive``
    holds the indices of the priority classes (``priority > 0``);
    ``overhead_s`` is the pipeline-state save/restore cost one
    preemption bills the displaced batch request.
    """

    class_id: np.ndarray
    interactive: FrozenSet[int]
    overhead_s: float = 0.005

    def __post_init__(self) -> None:
        self.class_id = np.asarray(self.class_id)
        if self.overhead_s < 0.0:
            raise ValueError(f"overhead_s must be non-negative, "
                             f"got {self.overhead_s}")


def preemption_spec(classes: Sequence[RequestClass],
                    class_id: Optional[np.ndarray],
                    overhead_s: float = 0.005
                    ) -> Optional[PreemptionSpec]:
    """The :class:`PreemptionSpec` of a class-tiered load, or ``None``
    when nothing can preempt (classless load, or no ``priority > 0``
    tier) — callers then stay on the exact FIFO kernel path."""
    if class_id is None or not classes:
        return None
    interactive = frozenset(i for i, c in enumerate(classes)
                            if c.priority > 0)
    if not interactive:
        return None
    return PreemptionSpec(class_id=class_id, interactive=interactive,
                          overhead_s=overhead_s)


# -- load ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServingLoad:
    """Open-loop request load for one serving simulation.

    ``rate`` — mean arrivals per second; ``n_requests`` — how many
    requests to generate; ``slo_s`` — per-request latency SLO (defaults
    to the scenario's ``t_qoe``); ``seed`` — arrival-process seed (same
    seed + same rate → identical arrivals; the exponential gaps scale
    with ``1/rate``, so traces at different rates are coupled and
    queueing is monotone in rate).  ``arrival`` picks a process from the
    zoo (default: homogeneous Poisson at ``rate``); ``classes`` splits
    requests into SLO tiers (default: one implicit class at ``slo_s``).
    """

    rate: float
    n_requests: int = DEFAULT_N_REQUESTS
    slo_s: Optional[float] = None
    seed: int = 0
    arrival: Optional[ArrivalProcess] = None
    classes: Tuple[RequestClass, ...] = ()

    def sample_arrivals(self) -> np.ndarray:
        proc = self.arrival if self.arrival is not None else \
            PoissonArrivals()
        arr = np.asarray(proc.sample(self.rate, self.n_requests, self.seed),
                         dtype=np.float64)
        if len(arr) and (arr[0] < 0.0 or np.any(np.diff(arr) < 0.0)):
            raise ValueError(f"{type(proc).__name__} produced an unsorted "
                             "or negative arrival trace")
        return arr

    def sample_class_ids(self, n: int) -> Optional[np.ndarray]:
        if not self.classes:
            return None
        return assign_classes(n, self.classes, self.seed)


# -- request records -----------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One request's life: arrival → service start → finish.
    ``finish`` is ``inf`` when the request could not be served (the
    static plan lost a device to churn)."""

    arrival: float
    start: float
    finish: float
    request_class: str = ""

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def waiting(self) -> float:
        return self.start - self.arrival

    @property
    def served(self) -> bool:
        return math.isfinite(self.finish)


class RequestLog(Sequence):
    """Array-backed request records — the ``ServingTrace.requests``
    container.  Iterating yields :class:`RequestRecord` views for
    compatibility, but metrics read the arrays directly so 10^6-request
    traces never materialize a million objects.

    The optional resilience arrays (``attempts``, ``hedged``) are only
    populated by the chaos engine (:mod:`repro_torch.resilience.engine`):
    ``attempts[i]`` counts how many times request ``i`` was issued
    (1 = served first try; >1 = retried), ``hedged[i]`` marks requests
    whose retry was hedged (re-issued without backoff).  Fault-free
    runs leave them ``None`` — all existing consumers see the exact
    historical container shape.
    """

    __slots__ = ("arrival", "start", "finish", "class_id", "classes",
                 "attempts", "hedged")

    def __init__(self, arrival, start, finish,
                 class_id: Optional[np.ndarray] = None,
                 classes: Tuple[RequestClass, ...] = (),
                 attempts: Optional[np.ndarray] = None,
                 hedged: Optional[np.ndarray] = None):
        self.arrival = np.asarray(arrival, dtype=np.float64)
        self.start = np.asarray(start, dtype=np.float64)
        self.finish = np.asarray(finish, dtype=np.float64)
        if not (len(self.arrival) == len(self.start) == len(self.finish)):
            raise ValueError("arrival/start/finish lengths differ")
        self.class_id = (None if class_id is None
                         else np.asarray(class_id))
        self.classes = tuple(classes)
        if self.class_id is not None and len(self.class_id) != len(self):
            raise ValueError("class_id length differs from arrivals")
        self.attempts = (None if attempts is None
                         else np.asarray(attempts, dtype=np.int64))
        self.hedged = (None if hedged is None
                       else np.asarray(hedged, dtype=bool))
        for name in ("attempts", "hedged"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != len(self):
                raise ValueError(f"{name} length differs from arrivals")

    @property
    def n_retried(self) -> int:
        """Requests that needed more than one attempt."""
        if self.attempts is None:
            return 0
        return int(np.count_nonzero(self.attempts > 1))

    @property
    def n_hedged(self) -> int:
        if self.hedged is None:
            return 0
        return int(np.count_nonzero(self.hedged))

    @classmethod
    def from_records(cls, records: Sequence[RequestRecord]) -> "RequestLog":
        return cls(np.asarray([r.arrival for r in records]),
                   np.asarray([r.start for r in records]),
                   np.asarray([r.finish for r in records]))

    def __len__(self) -> int:
        return len(self.arrival)

    def _class_name(self, i: int) -> str:
        if self.class_id is None:
            return ""
        return self.classes[int(self.class_id[i])].name

    def __getitem__(self, i):
        if isinstance(i, slice):
            cid = None if self.class_id is None else self.class_id[i]
            att = None if self.attempts is None else self.attempts[i]
            hed = None if self.hedged is None else self.hedged[i]
            return RequestLog(self.arrival[i], self.start[i],
                              self.finish[i], cid, self.classes,
                              attempts=att, hedged=hed)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return RequestRecord(float(self.arrival[i]), float(self.start[i]),
                             float(self.finish[i]), self._class_name(i))

    def latencies(self) -> np.ndarray:
        return self.finish - self.arrival

    def waits(self) -> np.ndarray:
        return self.start - self.arrival

    @property
    def served(self) -> np.ndarray:
        return np.isfinite(self.finish)

    def slo_values(self, default_slo: float) -> np.ndarray:
        """Per-request SLO: the request's class SLO, falling back to
        ``default_slo`` for classless logs and classes without one."""
        if self.class_id is None or not self.classes:
            return np.full(len(self), default_slo)
        per_class = np.asarray(
            [c.slo_s if c.slo_s is not None else default_slo
             for c in self.classes])
        return per_class[self.class_id]


# -- plan snapshots ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ActivePlan:
    """The kernel's view of whichever plan is currently live, with
    device keys mapped back to *original* topology indices and the
    per-request *non-idle* energy pre-stripped (the presence-interval
    idle billing below prices each idle second exactly once)."""

    latency: float
    interval: float
    per_device_energy: Dict[int, float]
    non_idle_energy: Dict[int, float]
    compute_busy: Dict[int, float]  # schedule compute-busy secs per request
    devices: Tuple[int, ...]


def service_interval(plan) -> float:
    """Steady-state admission interval of a plan's pipeline (fluid
    model): inference requests overlap across stages, so throughput is
    bounded by the bottleneck stage/resource span — delegated to
    :meth:`ScheduleResult.admission_interval`, the shared what-if
    primitive; training iterations serialize on the pipeline flush +
    gradient sync (full latency)."""
    if plan.training:
        return max(plan.latency, 1e-9)
    sched = plan.schedule
    if sched is not None and hasattr(sched, "admission_interval"):
        return sched.admission_interval(plan.n_stages, plan.latency)
    return max(plan.latency / max(plan.n_stages, 1), 1e-9)


def freeze_plan(plan, active: Sequence[int], topo=None) -> ActivePlan:
    """Snapshot a (possibly re-indexed) plan into original device space.

    ``compute_busy`` comes from the Phase-2 schedule
    (``ScheduleResult.busy_seconds`` of each stage's executor) when the
    plan carries one — a device whose stage computes for 80 ms of a
    300 ms request is *computing* 80 ms — falling back to the full plan
    latency for unrefined plans.  ``non_idle_energy`` strips the idle
    draw the plan priced into its own window (``p_idle * latency``) so
    the kernel's presence-interval idle billing prices each idle second
    exactly once even when pipelined windows overlap; pass ``topo=None``
    only when energy attribution is not needed.
    """
    idx = list(active)
    sched = plan.schedule
    compute: Dict[int, float] = {}
    for i, s in enumerate(plan.stages):
        t = None
        if sched is not None and hasattr(sched, "busy_seconds"):
            t = sched.busy_seconds(f"exec{i}") or None
        if t is None:
            t = plan.latency
        for d in s.devices:
            compute[idx[d]] = max(compute.get(idx[d], 0.0), t)
    energy = {idx[d]: e for d, e in plan.per_device_energy.items()}
    if topo is not None:
        non_idle = {
            d: max(e - topo.devices[d].p_idle * plan.latency, 0.0)
            for d, e in energy.items()}
    else:
        non_idle = {d: max(e, 0.0) for d, e in energy.items()}
    return ActivePlan(
        latency=plan.latency,
        interval=service_interval(plan),
        per_device_energy=energy,
        non_idle_energy=non_idle,
        compute_busy=compute,
        devices=tuple(sorted({idx[d] for d in plan.devices})))


# -- the vectorized admission core ---------------------------------------------
class Stream:
    """One admission queue replayed against a dynamics timeline.

    Owns the queue state (``next_free``), the request start/finish
    arrays, and the per-device energy/busy tallies.  ``serve_to(t)``
    vectorizes every pending arrival strictly before ``t`` under the
    current :class:`ActivePlan` via the Lindley recurrence (module
    docstring); ``chunk`` bounds the per-call array width — results are
    invariant to it (chunk=1 degenerates to the historical per-request
    loop), which the segmentation property tests assert.
    """

    def __init__(self, arrivals: np.ndarray,
                 plan: Optional[ActivePlan] = None,
                 alive: bool = True,
                 chunk: Optional[int] = None,
                 preempt: Optional[PreemptionSpec] = None):
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.arrivals = np.ascontiguousarray(arrivals, dtype=np.float64)
        self.plan = plan
        self.alive = alive
        self.chunk = chunk
        self.next_free = 0.0
        self.service_energy: Dict[int, float] = {}
        self.busy: Dict[int, float] = {}
        self._i = 0
        self._starts: List[np.ndarray] = []
        self._finishes: List[np.ndarray] = []
        # preemption is decided ONCE at construction: a spec whose trace
        # carries no interactive request at all stays on the exact
        # vectorized FIFO path (bit-identity with preemption unarmed)
        self.preempt: Optional[PreemptionSpec] = None
        if preempt is not None:
            ids = np.asarray(preempt.class_id)
            if len(ids) != len(self.arrivals):
                raise ValueError(
                    f"preempt.class_id length {len(ids)} differs from "
                    f"{len(self.arrivals)} arrivals")
            hot = np.isin(ids, list(preempt.interactive))
            if hot.any():
                self.preempt = preempt
                self._hot = hot
                self._fi = 0.0          # interactive admission frontier
                self._fb = 0.0          # batch admission frontier
                #: open interactive occupancy [start, end, charged]
                self._windows: List[List[float]] = []
                #: displaceable batch slots [req index, start, occ end]
                self._pending: List[List[float]] = []
                self._start_arr = np.zeros(len(self.arrivals))
                self._fin_arr = np.zeros(len(self.arrivals))

    def serve_to(self, t: float) -> None:
        """Serve every pending arrival with ``a < t`` (events at
        ``t <= a`` fire before ``a`` is admitted)."""
        self._serve(int(np.searchsorted(self.arrivals, t, side="left")))

    def drain(self) -> None:
        self._serve(len(self.arrivals))

    def stall(self, t: float, stall_s: float) -> None:
        """A migration stall pauses admissions: the pipeline is busy
        moving state until ``max(next_free, t) + stall_s``."""
        if stall_s > 0.0:
            self.next_free = max(self.next_free, t) + stall_s
            if self.preempt is not None:
                self._fi = max(self._fi, t) + stall_s
                self._fb = max(self._fb, t) + stall_s

    def _serve(self, j: int) -> None:
        i = self._i
        if j <= i:
            return
        a = self.arrivals[i:j]
        self._i = j
        n = j - i
        if not self.alive or self.plan is None:
            # degraded: the plan lost a device — requests fail outright,
            # consuming no pipeline capacity and no energy
            if self.preempt is not None:
                self._start_arr[i:j] = a
                self._fin_arr[i:j] = math.inf
            else:
                self._starts.append(a.copy())
                self._finishes.append(np.full(n, math.inf))
            return
        p = self.plan
        if self.preempt is not None:
            self._serve_preemptive(a, i)
        else:
            step = n if self.chunk is None else self.chunk
            for c in range(0, n, step):
                seg = a[c:c + step]
                if len(seg) == 1:   # degenerate chunk = the old loop
                    start = np.asarray([max(float(seg[0]), self.next_free)])
                else:
                    k = np.arange(len(seg), dtype=np.float64)
                    shifted = seg - p.interval * k
                    start = p.interval * k + np.maximum(
                        self.next_free, np.maximum.accumulate(shifted))
                self._starts.append(start)
                self._finishes.append(start + p.latency)
                self.next_free = float(start[-1]) + p.interval
        for d, e in p.non_idle_energy.items():
            self.service_energy[d] = self.service_energy.get(d, 0.0) + n * e
        for d, b in p.compute_busy.items():
            self.busy[d] = self.busy.get(d, 0.0) + n * b

    def _serve_preemptive(self, a: np.ndarray, i0: int) -> None:
        """The two-class priority sweep (scalar — preemption is a
        per-request control decision, so the closed-form segment trick
        doesn't apply; state carries across calls, so results stay
        chunk- and segmentation-invariant).

        Interactive requests run a pure Lindley recurrence on their own
        frontier — they only ever queue behind other interactive
        requests.  Batch requests chain on the batch frontier but (a)
        may not *begin* inside a known interactive occupancy window
        (the interactive is already holding the stage) and (b) are
        *suspended* by every interactive window that opens strictly
        inside their occupancy: each such preemption extends the slot
        (and the request's finish) by the interactive's occupancy plus
        the save/restore overhead.  An interactive arriving later whose
        window opens inside an already-admitted pending slot displaces
        it retroactively, re-propagating the chain of later pending
        slots.  Each interactive window displaces at most one batch
        slot (occupancies never overlap).
        """
        p = self.plan
        interval, lat = p.interval, p.latency
        oh = self.preempt.overhead_s
        for k in range(len(a)):
            i = i0 + k
            t = float(a[k])
            # windows fully in the past can no longer cover or suspend
            # any future admission; settled batch slots are final
            self._windows = [w for w in self._windows if w[1] > t]
            self._pending = [s for s in self._pending if s[2] > t]
            if self._hot[i]:
                s = max(t, self._fi)
                w = [s, s + interval, False]
                # retroactive preemption: this window opens inside an
                # already-admitted (still displaceable) batch slot
                for kk, slot in enumerate(self._pending):
                    if slot[1] < s < slot[2]:
                        w[2] = True
                        bump = interval + oh
                        slot[2] += bump
                        self._fin_arr[int(slot[0])] += bump
                        prev_end = slot[2]
                        for later in self._pending[kk + 1:]:
                            if later[1] < prev_end:
                                d = prev_end - later[1]
                                later[1] += d
                                later[2] += d
                                self._start_arr[int(later[0])] += d
                                self._fin_arr[int(later[0])] += d
                            prev_end = later[2]
                        self._fb = max(self._fb, prev_end)
                        break
                self._windows.append(w)
                self._fi = s + interval
                self._start_arr[i] = s
                self._fin_arr[i] = s + lat
            else:
                s = max(t, self._fb)
                moved = True
                while moved:    # can't begin inside an interactive hold
                    moved = False
                    for w in self._windows:
                        if w[0] <= s < w[1]:
                            s = w[1]
                            moved = True
                end = s + interval
                changed = True
                while changed:  # known windows opening inside suspend it
                    changed = False
                    for w in self._windows:
                        if not w[2] and s < w[0] < end:
                            w[2] = True
                            end += (w[1] - w[0]) + oh
                            changed = True
                self._start_arr[i] = s
                self._fin_arr[i] = s + lat + (end - s - interval)
                self._pending.append([float(i), s, end])
                self._fb = end

    # -- results ----------------------------------------------------------------
    def served_through(self) -> int:
        return self._i

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(arrival, start, finish) over every request served so far."""
        arr = self.arrivals[:self._i]
        if self.preempt is not None:
            return (arr, self._start_arr[:self._i].copy(),
                    self._fin_arr[:self._i].copy())
        if not self._starts:
            return arr, arr.copy(), arr.copy()
        return (arr, np.concatenate(self._starts),
                np.concatenate(self._finishes))

    def last_finite_finish(self) -> float:
        if self.preempt is not None:
            fin = self._fin_arr[:self._i]
            fin = fin[np.isfinite(fin)]
            return float(fin.max()) if len(fin) else 0.0
        out = 0.0
        for f in self._finishes:
            fin = f[np.isfinite(f)]
            if len(fin):
                out = max(out, float(fin[-1]))
        return out


def describe_event(ev: DynamicsEvent) -> str:
    """A human label for a bare event — fault kinds get descriptive
    labels (unannounced faults are the interesting rows in a chaos
    trace); announced-only events keep the historical ``event@t`` form."""
    parts = []
    if ev.crash:
        parts.append("crash: device " + ",".join(map(str, ev.crash)))
    if ev.link_down:
        parts.append("link down: " + ",".join(ev.link_down))
    if ev.link_up:
        parts.append("link up: " + ",".join(ev.link_up))
    if ev.straggler:
        parts.append("straggler: " + ",".join(
            f"{d}->x{format(f, '.3g')}" for d, f in sorted(ev.straggler.items())))
    if not parts:
        return f"event@t={ev.t:g}s"
    return "; ".join(parts)


def normalize_timeline(source) -> List[Tuple[str, DynamicsEvent]]:
    """``DynamicsEvent``s and/or (label, event) pairs → labeled pairs
    sorted by time (the shape both simulate modes replay)."""
    timeline: List[Tuple[str, DynamicsEvent]] = []
    for item in source or ():
        if isinstance(item, DynamicsEvent):
            timeline.append((describe_event(item), item))
        else:
            label, ev = item
            timeline.append((label, ev))
    return sorted(timeline, key=lambda kv: kv[1].t)


def replay(timeline: Sequence[Tuple[str, DynamicsEvent]],
           streams: Sequence[Stream],
           fire) -> None:
    """Drive every stream through one labeled timeline: serve each
    inter-event segment as array ops, then fall back to discrete
    stepping for the adapter (``fire(label, event)`` mutates stream
    plans/aliveness and books stalls via the Stream API), and drain the
    tails once the timeline is exhausted."""
    for label, ev in timeline:
        for s in streams:
            s.serve_to(ev.t)
        fire(label, ev)
    for s in streams:
        s.drain()


# -- presence & ownership (energy attribution) ---------------------------------
def overlap_seconds(intervals: Sequence[Tuple[float, float]],
                    lo: float, hi: float) -> float:
    """Total length of ``intervals`` ∩ ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


class PresenceTracker:
    """Per-device presence intervals driven by ``leave``/``join`` churn.

    Idle draw is billed only while a device is *present*: a device that
    leaves at ``t`` stops drawing idle power at ``t`` (the historical
    whole-horizon billing was a documented conservative upper bound).
    """

    def __init__(self, n_devices: int, t0: float = 0.0):
        self._open: Dict[int, Optional[float]] = {
            d: t0 for d in range(n_devices)}
        self._closed: Dict[int, List[Tuple[float, float]]] = {
            d: [] for d in range(n_devices)}

    def apply(self, event: DynamicsEvent) -> None:
        for d in event.leave:
            since = self._open.get(d)
            if since is not None:
                if event.t > since:
                    self._closed[d].append((since, event.t))
                self._open[d] = None
        for d in event.join:
            if d in self._open and self._open[d] is None:
                self._open[d] = event.t

    def intervals(self, horizon: float
                  ) -> Dict[int, List[Tuple[float, float]]]:
        out: Dict[int, List[Tuple[float, float]]] = {}
        for d, closed in self._closed.items():
            iv = [(s, min(e, horizon)) for s, e in closed if s < horizon]
            since = self._open[d]
            if since is not None and since < horizon:
                iv.append((since, horizon))
            out[d] = iv
        return out

    def seconds(self, horizon: float) -> Dict[int, float]:
        return {d: sum(e - s for s, e in iv)
                for d, iv in self.intervals(horizon).items()}


class OwnershipTracker:
    """Which tenant owned each device, over time, across rebalances.

    Fleet idle draw is prorated across *owning* tenants by ownership
    interval — a device that changed hands mid-run bills each owner for
    its own span (the historical attribution handed the whole horizon
    to the final owner); spans owned by no tenant land in the
    fleet-wide totals only.
    """

    def __init__(self, assignments: Mapping[str, Sequence[int]],
                 t0: float = 0.0):
        self._history: List[Tuple[float, Dict[str, Tuple[int, ...]]]] = [
            (t0, self._snap(assignments))]

    @staticmethod
    def _snap(assignments) -> Dict[str, Tuple[int, ...]]:
        return {name: tuple(devs) for name, devs in assignments.items()}

    def update(self, t: float, assignments) -> None:
        snap = self._snap(assignments)
        if snap != self._history[-1][1]:
            self._history.append((t, snap))

    @property
    def history(self) -> List[Tuple[float, Dict[str, Tuple[int, ...]]]]:
        return list(self._history)

    def spans(self, horizon: float
              ) -> Dict[int, List[Tuple[float, float, str]]]:
        """Per-device ``(from, to, owner)`` spans clipped to the run."""
        out: Dict[int, List[Tuple[float, float, str]]] = {}
        bounds = [t for t, _ in self._history] + [horizon]
        for (t0, snap), t1 in zip(self._history, bounds[1:]):
            hi = min(t1, horizon)
            if hi <= t0:
                continue
            for name, devs in snap.items():
                for d in devs:
                    spans = out.setdefault(d, [])
                    if spans and spans[-1][2] == name \
                            and spans[-1][1] == t0:
                        spans[-1] = (spans[-1][0], hi, name)
                    else:
                        spans.append((t0, hi, name))
        return out


# -- the result container ------------------------------------------------------
@dataclasses.dataclass
class ServingTrace:
    """Everything one request-level simulation produced."""

    scenario: str
    strategy: str
    load: ServingLoad
    slo_s: float
    requests: RequestLog
    actions: List["AdapterAction"]
    per_device_energy: Dict[int, float]
    #: schedule-level compute-busy seconds per device over the run
    #: (from ``ScheduleResult.busy_seconds``) — the utilization input
    per_device_busy: Dict[int, float]
    horizon_s: float
    #: presence seconds actually billed for idle draw per device — the
    #: whole horizon unless the device left the fleet mid-run
    per_device_idle_s: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    #: chaos-engine fault records (one dict per injected fault: kind,
    #: target, onset/detect/restore times, mttr_s, affected) — empty for
    #: fault-free runs
    faults: List[Dict[str, object]] = dataclasses.field(default_factory=list)
    #: mean time-to-recovery over service-affecting faults (onset →
    #: serving restored), ``None`` when no fault touched the service
    mttr_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not isinstance(self.requests, RequestLog):
            self.requests = RequestLog.from_records(self.requests)

    def utilization(self, device: int) -> float:
        """Fraction of the run this device spent computing.

        The *raw* busy/horizon ratio — a value above 1.0 means the
        admission policy oversubscribed the device (more compute-seconds
        queued than wall-clock available).  The old silent clamp to 1.0
        hid exactly that signal from the multi-tenant path; use
        :meth:`oversubscribed` for the boolean verdict.
        """
        if self.horizon_s <= 0.0:
            return 0.0
        return self.per_device_busy.get(device, 0.0) / self.horizon_s

    def oversubscribed(self, device: int, tol: float = 1e-6) -> bool:
        """True when more busy-seconds were booked on ``device`` than the
        run's horizon holds — the plan (or a co-tenant) admitted faster
        than the device can serve."""
        return self.utilization(device) > 1.0 + tol

    @property
    def oversubscribed_devices(self) -> List[int]:
        return sorted(d for d in self.per_device_busy
                      if self.oversubscribed(d))

    # -- latency distribution ---------------------------------------------------
    def latencies(self) -> np.ndarray:
        return self.requests.latencies()

    def percentile(self, q: float) -> float:
        """Latency percentile over ALL requests; ``inf`` (not NaN) when
        the quantile falls among failed/unserved ones."""
        with np.errstate(invalid="ignore"):
            v = float(np.percentile(self.latencies(), q))
        return math.inf if math.isnan(v) else v

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean_latency(self) -> float:
        lat = self.latencies()
        served = lat[self.requests.served]
        return float(np.mean(served)) if len(served) else math.inf

    @property
    def slo_attainment(self) -> float:
        """Fraction of requests served within their SLO (failed =
        missed; multi-class loads judge each request against its own
        tier's SLO)."""
        n = len(self.requests)
        if not n:
            return 1.0
        lat = self.latencies()
        ok = self.requests.served & (
            lat <= self.requests.slo_values(self.slo_s))
        return float(np.count_nonzero(ok)) / n

    @property
    def n_failed(self) -> int:
        return int(np.count_nonzero(~self.requests.served))

    @property
    def n_retried(self) -> int:
        """Requests that needed more than one attempt (chaos runs)."""
        return self.requests.n_retried

    @property
    def n_hedged(self) -> int:
        """Requests whose retry was hedged (chaos runs)."""
        return self.requests.n_hedged

    @property
    def failed_rate(self) -> float:
        n = len(self.requests)
        return self.n_failed / n if n else 0.0

    @property
    def energy(self) -> float:
        return sum(self.per_device_energy.values())

    @property
    def replans(self) -> int:
        return sum(1 for a in self.actions if a.action == "replan")

    def class_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-SLO-tier latency/attainment breakdown (empty for
        single-class loads)."""
        log = self.requests
        if log.class_id is None or not log.classes:
            return {}
        lat = self.latencies()
        served = log.served
        slo = log.slo_values(self.slo_s)
        out: Dict[str, Dict[str, float]] = {}
        for ci, cls in enumerate(log.classes):
            m = log.class_id == ci
            n = int(np.count_nonzero(m))
            if not n:
                out[cls.name] = {"n": 0}
                continue
            with np.errstate(invalid="ignore"):
                p50, p95, p99 = (float(np.percentile(lat[m], q))
                                 for q in (50.0, 95.0, 99.0))
            ok = served[m] & (lat[m] <= slo[m])
            out[cls.name] = {
                "n": n,
                "slo_s": float(slo[m][0]),
                "p50": math.inf if math.isnan(p50) else p50,
                "p95": math.inf if math.isnan(p95) else p95,
                "p99": math.inf if math.isnan(p99) else p99,
                "slo_attainment": float(np.count_nonzero(ok)) / n,
            }
        return out

    def to_dict(self) -> Dict[str, object]:
        out = {
            "scenario": self.scenario,
            "strategy": self.strategy,
            "rate_rps": _json_num(self.load.rate),
            "n_requests": len(self.requests),
            "slo_s": _json_num(self.slo_s),
            "latency_s": {"p50": _json_num(self.p50),
                          "p95": _json_num(self.p95),
                          "p99": _json_num(self.p99),
                          "mean": _json_num(self.mean_latency)},
            "slo_attainment": self.slo_attainment,
            "failed_requests": self.n_failed,
            "energy_j": _json_num(self.energy),
            "per_device_energy_j": {str(d): _json_num(e)
                                    for d, e in
                                    sorted(self.per_device_energy.items())},
            "per_device_utilization": {str(d): self.utilization(d)
                                       for d in
                                       sorted(self.per_device_energy)},
            "oversubscribed_devices": self.oversubscribed_devices,
            "horizon_s": _json_num(self.horizon_s),
            "actions": [{
                "t": a.t, "label": a.label, "action": a.action,
                "react_s": _json_num(a.react_s),
                "stall_s": _json_num(a.stall_s),
                "latency_after_s": _json_num(a.latency_after),
            } for a in self.actions],
        }
        classes = self.class_metrics()
        if classes:
            out["classes"] = {
                name: {k: (_json_num(v) if isinstance(v, float) else v)
                       for k, v in row.items()}
                for name, row in classes.items()}
        if self.per_device_idle_s:
            out["per_device_idle_s"] = {
                str(d): _json_num(s)
                for d, s in sorted(self.per_device_idle_s.items())}
        if self.faults or self.mttr_s is not None:
            out["retried_requests"] = self.n_retried
            out["hedged_requests"] = self.n_hedged
            out["mttr_s"] = _json_num(self.mttr_s) \
                if self.mttr_s is not None else None
            out["faults"] = [
                {k: (_json_num(v) if isinstance(v, float) else v)
                 for k, v in f.items()} for f in self.faults]
        return out

    def summary(self) -> str:
        def fmt(x: float) -> str:
            return f"{x * 1e3:.0f} ms" if math.isfinite(x) else "unserved"
        lines = [
            f"serving {self.scenario} [{self.strategy}]: "
            f"{len(self.requests)} requests @ {self.load.rate:g}/s "
            f"over {self.horizon_s:.1f}s",
            f"latency p50/p95/p99: {fmt(self.p50)} / {fmt(self.p95)} / "
            f"{fmt(self.p99)}  (SLO {self.slo_s:g}s)",
            f"SLO attainment {self.slo_attainment:.1%}"
            + (f"  ({self.n_failed} failed)" if self.n_failed else ""),
            f"energy {self.energy:.1f} J across "
            f"{len(self.per_device_energy)} devices (idle draw included)",
        ]
        for name, row in self.class_metrics().items():
            if row.get("n"):
                lines.append(
                    f"  class {name:12s} n={row['n']:<6d} "
                    f"p99 {fmt(row['p99'])}  "
                    f"SLO {row['slo_attainment']:.1%} "
                    f"(<= {row['slo_s']:g}s)")
        for a in self.actions:
            stall = f" stall {a.stall_s:.2f}s" if a.stall_s > 0 else ""
            lines.append(f"  t={a.t:6.1f}s  {a.label:48s} -> "
                         f"{a.action:10s}{stall} latency "
                         f"{fmt(a.latency_after)}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class AdapterAction:
    """What the runtime layer did about one timeline event."""

    t: float
    label: str
    #: "reschedule" | "replan" | "repriced" | "degraded" — plus the
    #: chaos-engine verdicts: "fallback" (instant precomputed-ladder
    #: switch), "brownout" (no QoE-feasible plan: batch admissions
    #: shed), "unobserved" (a pure fault the announced-event path
    #: cannot see)
    action: str
    react_s: float
    stall_s: float
    latency_after: float   # per-request service latency after the event


__all__ = [
    "DEFAULT_N_REQUESTS",
    "ArrivalProcess", "PoissonArrivals", "TraceArrivals",
    "DiurnalArrivals", "MMPPArrivals", "FlashCrowdArrivals",
    "poisson_arrivals",
    "RequestClass", "interactive_batch", "assign_classes",
    "PreemptionSpec", "preemption_spec",
    "ServingLoad", "RequestRecord", "RequestLog",
    "ActivePlan", "freeze_plan", "service_interval",
    "Stream", "replay", "normalize_timeline", "describe_event",
    "PresenceTracker", "OwnershipTracker", "overlap_seconds",
    "ServingTrace", "AdapterAction",
]
