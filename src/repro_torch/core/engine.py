# A copy of src/repro/core/engine.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Discrete-event execution engine for plans.

Models heterogeneous compute (exclusive per-device executors) and
contention-prone networks at two fidelities:

* ``comm_mode="fair"`` — transfers start as soon as ready and *fluid-share*
  each network resource (max-min style equal split). This is what a real
  shared WiFi medium does to contention-oblivious planners (Fig. 2).
* ``comm_mode="scheduled"`` — Dora's Phase-2 behavior: transfers are
  chunked and each chunk occupies its resources exclusively, so the
  scheduler's priority order decides *when* bytes flow (spatial→temporal
  sharing, §4.2).

The same engine powers the network scheduler's evaluation, the edge
simulator behind every paper figure, and the runtime adapter's what-if
queries.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Task:
    name: str
    kind: str                       # "compute" | "comm"
    duration: float = 0.0           # compute seconds (at nominal speed)
    nbytes: float = 0.0             # comm payload bytes
    executor: Optional[str] = None  # compute resource token (exclusive)
    resources: Tuple[str, ...] = () # network resources traversed
    deps: Tuple[str, ...] = ()
    priority: float = 0.0           # larger = schedule earlier
    net_latency: float = 0.0        # fixed per-message latency (WiFi MAC/RTT)

    def clone(self, **kw) -> "Task":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ScheduleResult:
    makespan: float
    start: Dict[str, float]
    finish: Dict[str, float]
    resource_busy: Dict[str, float]         # busy seconds per resource
    device_busy: Dict[str, float]           # busy seconds per executor

    def utilization(self, name: str) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.resource_busy.get(name, self.device_busy.get(name, 0.0)) / self.makespan

    def busy_seconds(self, name: str) -> float:
        """Busy seconds of a resource or executor within the makespan."""
        return self.resource_busy.get(name, self.device_busy.get(name, 0.0))

    def idle_seconds(self, name: str) -> float:
        """Seconds ``name`` sat idle inside this schedule's makespan
        (the serving simulator's per-device idle-draw input)."""
        return max(self.makespan - self.busy_seconds(name), 0.0)

    def admission_interval(self, n_stages: int, latency: float) -> float:
        """Steady-state admission interval of a pipeline executing this
        schedule (the serving kernel's what-if primitive).

        A pipeline's steady-state throughput is bounded by its
        *bottleneck* — the busiest stage executor (``exec{i}``) or
        network resource per request — not by the average stage span:
        stages overlap across requests, so admitting faster than the
        bottleneck span oversubscribes that device.  Falls back to the
        balanced-pipeline approximation ``latency / n_stages`` when the
        schedule carries no busy accounting (hand-built results)."""
        spans = [self.busy_seconds(f"exec{i}") for i in range(n_stages)]
        spans += list(self.resource_busy.values())
        bottleneck = max((s for s in spans if s), default=0.0)
        if bottleneck > 0.0:
            # the bottleneck span never exceeds the makespan, but guard
            # against hand-built schedules that claim otherwise
            return max(min(bottleneck, latency), 1e-9)
        return max(latency / max(n_stages, 1), 1e-9)


class EventEngine:
    def __init__(self, tasks: Sequence[Task], resource_caps: Dict[str, float],
                 comm_mode: str = "scheduled",
                 compute_speed: Optional[Dict[str, float]] = None,
                 structure: Optional[tuple] = None):
        """``resource_caps`` — bytes/sec per network resource.
        ``compute_speed`` — multiplicative speed factor per executor
        (runtime dynamics: 0.5 = device at half speed).
        ``structure`` — a previous engine's :meth:`structure` for the
        *same task list* (dependency graph + topological order), so
        repeated engines over one CEP graph skip the O(V+E) rebuild
        (see :class:`repro_torch.core.cep.CEPCache`)."""
        self.caps = dict(resource_caps)
        self.mode = comm_mode
        self.speed = dict(compute_speed or {})
        if structure is None:
            structure = task_structure(tasks)
        self.tasks, self._succ, self._ndeps, self._order = structure

    def structure(self) -> tuple:
        """Shareable dependency structure: (tasks-by-name, successors,
        dependency counts, topological order). Valid for any engine
        built over the same task list."""
        return (self.tasks, self._succ, self._ndeps, self._order)

    # -- critical-path priorities -------------------------------------------------
    def assign_priorities(self,
                          dist: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
        """Set each task's priority to its downstream critical path.

        Pass a ``dist`` previously returned for the same (task graph,
        resource caps) to re-apply cached priorities without the O(V+E)
        recomputation; the mapping is returned either way so callers can
        cache it (priorities depend on caps but not on compute speed or
        comm mode)."""
        if dist is None:
            dist = {}
            for name in reversed(self._order):
                t = self.tasks[name]
                base = t.duration if t.kind == "compute" else self._full_bw_time(t)
                succ_max = max((dist[s] for s in self._succ[name]), default=0.0)
                dist[name] = base + succ_max
        for name, d in dist.items():
            self.tasks[name].priority = d
        return dist

    def _full_bw_time(self, t: Task) -> float:
        if not t.resources or t.nbytes <= 0:
            return 0.0
        cap = min(self.caps[r] for r in t.resources)
        return t.net_latency + t.nbytes / cap

    # -- simulation -----------------------------------------------------------------
    def run(self) -> ScheduleResult:
        EPS = 1e-12
        tasks = self.tasks
        succ = self._succ
        caps = self.caps
        speed = self.speed
        scheduled = self.mode == "scheduled"
        heappush, heappop = heapq.heappush, heapq.heappop
        ndeps = dict(self._ndeps)
        ready: List[Tuple[float, str]] = []     # (-priority, name)
        for n, d in ndeps.items():
            if d == 0:
                heappush(ready, (-tasks[n].priority, n))

        t_now = 0.0
        start: Dict[str, float] = {}
        finish: Dict[str, float] = {}
        res_busy: Dict[str, float] = {r: 0.0 for r in caps}
        dev_busy: Dict[str, float] = {}

        running_compute: List[Tuple[float, str]] = []     # heap (end, name)
        busy_exec: Dict[str, str] = {}                    # executor -> task
        busy_net: Dict[str, str] = {}                     # resource -> task (scheduled mode)
        active_comm: Dict[str, float] = {}                # task -> remaining bytes
        ready_at: Dict[str, float] = {}                   # comm -> end of latency phase
        share: Dict[str, int] = {}                        # active flows per resource
        # a task that fails to start parks under the executor/resource
        # tokens blocking it (they free exclusively in `complete`); each
        # waiting queue is a priority heap and a freed token promotes
        # only its best parked waiter into the ready heap — promoting
        # every waiter on every completion is quadratic on a shared
        # medium with hundreds of queued chunks
        waiting: Dict[str, List[Tuple[float, str]]] = {}  # token -> heap[(pr, name)]
        parked: set = set()
        # scheduled mode holds every resource exclusively, so an active
        # flow's rate is a constant: min capacity along its route
        fixed_rate: Dict[str, float] = {}

        def promote(token: str) -> None:
            """Move the best still-parked waiter of a freed token into
            the ready heap (stale heap entries are skipped)."""
            w = waiting.get(token)
            while w:
                item = heapq.heappop(w)
                if item[1] in parked:
                    parked.discard(item[1])
                    heappush(ready, item)
                    break

        def try_start(pr: float, name: str) -> None:
            t = tasks[name]
            if t.kind == "compute":
                ex = t.executor
                if ex is not None and ex in busy_exec:
                    parked.add(name)
                    heappush(waiting.setdefault(ex, []), (pr, name))
                    return
                dur = t.duration / speed.get(ex, 1.0)
                start[name] = t_now
                heappush(running_compute, (t_now + dur, name))
                if ex is not None:
                    busy_exec[ex] = name
                    dev_busy[ex] = dev_busy.get(ex, 0.0) + dur
                return
            # comm
            if t.nbytes <= EPS or not t.resources:
                start[name] = t_now
                heappush(running_compute, (t_now, name))  # instantaneous
                return
            if scheduled:
                holders = [r for r in t.resources if r in busy_net]
                if holders:
                    parked.add(name)
                    for r in holders:
                        heappush(waiting.setdefault(r, []), (pr, name))
                    # this task may have been the designated waiter of a
                    # token that is free right now — hand that token to
                    # its next waiter so it doesn't idle a whole wave
                    for r in t.resources:
                        if r not in busy_net and waiting.get(r):
                            promote(r)
                    return
                for r in t.resources:
                    busy_net[r] = name
                if name not in fixed_rate:
                    fixed_rate[name] = min(caps[r] for r in t.resources)
            start[name] = t_now
            active_comm[name] = t.nbytes
            ready_at[name] = t_now + t.net_latency   # bytes flow after the latency
            for r in t.resources:
                share[r] = share.get(r, 0) + 1
            return

        def complete(name: str) -> None:
            finish[name] = t_now
            t = tasks[name]
            if t.kind == "compute" and t.executor is not None:
                if busy_exec.get(t.executor) == name:
                    del busy_exec[t.executor]
                    promote(t.executor)
            if t.kind == "comm":
                for r in t.resources:
                    if busy_net.get(r) == name:
                        del busy_net[r]
                        promote(r)
            for s in succ[name]:
                ndeps[s] -= 1
                if ndeps[s] == 0:
                    heappush(ready, (-tasks[s].priority, s))

        n_done = 0
        n_total = len(tasks)
        while n_done < n_total:
            # start everything we can, highest priority first
            while ready:
                pr, name = heappop(ready)
                try_start(pr, name)
            # advance time to next completion. Flows whose predicted
            # finish is the horizon are completed BY TIME, not by a
            # residual-byte check: on fast links (TPU ICI, multi-GbE) the
            # final drain can leave a few µbytes of float-cancellation
            # residue whose drain time rounds to zero ulps, pinning
            # t_now forever if completion only looked at bytes.
            # max-min fluid share: each flow runs at its bottleneck
            # resource's capacity split over that resource's active flows
            # (the `share` counts, maintained incrementally). Scheduled
            # mode holds resources exclusively (share ≡ 1), so the rate
            # is each flow's precomputed route minimum.
            if scheduled:
                rates = fixed_rate
            else:
                rates = {name: min(caps[r] / share[r]
                                   for r in tasks[name].resources)
                         for name in active_comm}
            next_t = math.inf
            comm_finishers: List[str] = []
            if running_compute:
                next_t = running_compute[0][0]
            for name, rem in active_comm.items():
                r = rates[name]
                if r > 0:
                    eff_start = ready_at.get(name, 0.0)
                    if eff_start < t_now:
                        eff_start = t_now
                    f = eff_start + rem / r
                    tol = EPS + 1e-12 * abs(next_t if next_t < math.inf else f)
                    if f < next_t - tol:
                        next_t = f
                        comm_finishers = [name]
                    elif f <= next_t + tol:
                        comm_finishers.append(name)
            if next_t is math.inf:
                stuck = [n for n, d in ndeps.items() if d > 0 or n not in finish]
                raise RuntimeError(f"engine stalled at t={t_now}; pending={stuck[:5]}")
            # drain comm bytes (only past each task's latency phase)
            dt = next_t - t_now
            if dt < 0.0:
                dt = 0.0
            for name in active_comm:
                flow_from = ready_at.get(name, 0.0)
                if flow_from < t_now:
                    flow_from = t_now
                flow = next_t - flow_from
                if flow > 0.0:
                    active_comm[name] -= rates[name] * flow
                for res in tasks[name].resources:
                    res_busy[res] += dt
            t_now = next_t
            # completions
            while running_compute and running_compute[0][0] <= t_now + EPS:
                _, name = heappop(running_compute)
                complete(name)
                n_done += 1
            for name in comm_finishers:
                if name in active_comm:
                    del active_comm[name]
                    for r in tasks[name].resources:
                        share[r] -= 1
                    complete(name)
                    n_done += 1
            for name in list(active_comm):
                if active_comm[name] <= 1e-6:
                    del active_comm[name]
                    for r in tasks[name].resources:
                        share[r] -= 1
                    complete(name)
                    n_done += 1

        return ScheduleResult(makespan=t_now, start=start, finish=finish,
                              resource_busy=res_busy, device_busy=dev_busy)


def chunk_comm_tasks(tasks: Sequence[Task], w: int) -> List[Task]:
    """Split every comm task into ``w`` chained chunks (§4.2 chunking).

    Chunk 0 inherits the original deps; successors of the original task
    are re-pointed at the final chunk.
    """
    if w <= 1:
        return list(tasks)
    rename: Dict[str, str] = {}
    out: List[Task] = []
    for t in tasks:
        if t.kind != "comm" or t.nbytes <= 0:
            out.append(t)
            continue
        nb = t.nbytes / w
        last = None
        for i in range(w):
            name = f"{t.name}#c{i}"
            deps = t.deps if i == 0 else (last,)
            out.append(Task(name=name, kind=t.kind, duration=t.duration,
                            nbytes=nb, executor=t.executor,
                            resources=t.resources, deps=tuple(deps),
                            priority=t.priority, net_latency=t.net_latency))
            last = name
        rename[t.name] = last
    fixed: List[Task] = []
    for t in out:
        deps = tuple(rename.get(d, d) for d in t.deps)
        if deps != t.deps:
            t = Task(name=t.name, kind=t.kind, duration=t.duration,
                     nbytes=t.nbytes, executor=t.executor,
                     resources=t.resources, deps=deps,
                     priority=t.priority, net_latency=t.net_latency)
        fixed.append(t)
    return fixed


def task_structure(tasks: Sequence[Task],
                   base: Optional[tuple] = None) -> tuple:
    """Dependency structure for :class:`EventEngine`: ``(tasks-by-name,
    successors, dependency counts, topological order)``.

    With ``base`` — the structure of the *unchunked* task list the
    chunked ``tasks`` were derived from — everything is rebuilt by a
    single linear walk of the base topological order (a comm task's
    chunk chain slots into its position), skipping the dependency
    validation and Kahn's algorithm.
    """
    by_name = {t.name: t for t in tasks}
    succ: Dict[str, List[str]] = {n: [] for n in by_name}
    ndeps: Dict[str, int] = {}
    for t in tasks:
        missing = [d for d in t.deps if d not in by_name]
        if missing:
            raise ValueError(f"task {t.name} depends on unknown {missing}")
        ndeps[t.name] = len(t.deps)
        for d in t.deps:
            succ[d].append(t.name)
    if base is not None:
        base_order = base[3]
        order: List[str] = []
        for name in base_order:
            if name in by_name:
                order.append(name)
            else:                       # comm task replaced by its chunks
                i = 0
                while f"{name}#c{i}" in by_name:
                    order.append(f"{name}#c{i}")
                    i += 1
        return by_name, succ, ndeps, order
    indeg = dict(ndeps)
    ready = [n for n, d in indeg.items() if d == 0]
    order = []
    while ready:
        n = ready.pop()
        order.append(n)
        for s in succ[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != len(by_name):
        raise ValueError("task graph has a cycle")
    return by_name, succ, ndeps, order
