# A copy of src/repro/core/cep.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Communication-Expanded Planning (CEP) graph construction (§4.2).

Expands a ``ParallelismPlan`` into per-(stage, microbatch) compute and
communication tasks with full dependency edges, annotated with durations
(compute) and byte counts + traversed network resources (comm). The
Phase-2 scheduler and the edge simulator both execute this graph.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .device import Topology
from .engine import EventEngine, Task, chunk_comm_tasks, task_structure
from .plans import ParallelismPlan


def _route(topo: Topology, src_devs, dst_devs) -> Tuple[str, ...]:
    """Network resources an inter-stage transfer traverses (representative
    bottleneck pair: every sample crosses the same shared medium in WiFi
    settings; for rings we take the first-device route)."""
    pairs = [(i, j) for i in src_devs for j in dst_devs if i != j]
    if not pairs:
        return ()
    i, j = pairs[0]
    return tuple(r.name for r in topo.resources_between(i, j))


def _group_route(topo: Topology, devs) -> Tuple[str, ...]:
    """Resources a data-parallel gradient all-reduce occupies."""
    names: List[str] = []
    for a, b in zip(devs[:-1], devs[1:]):
        for r in topo.resources_between(a, b):
            if r.name not in names:
                names.append(r.name)
    if len(devs) > 1:
        for r in topo.resources_between(devs[-1], devs[0]):
            if r.name not in names:
                names.append(r.name)
    return tuple(names)


def build_cep(plan: ParallelismPlan, topo: Topology) -> List[Task]:
    """CEP tasks for one training iteration (or one inference forward)."""
    S = len(plan.stages)
    M = plan.n_microbatches
    training = plan.training
    tasks: List[Task] = []

    def _lat(route: Tuple[str, ...]) -> float:
        return sum(topo.resources[r].latency for r in route)

    for s, st in enumerate(plan.stages):
        exec_name = f"exec{s}"
        down_route = _route(topo, st.devices, plan.stages[s + 1].devices) \
            if s + 1 < S else ()
        up_route = _route(topo, st.devices, plan.stages[s - 1].devices) \
            if s > 0 else ()
        for m in range(M):
            fdeps: List[str] = []
            if s > 0:
                fdeps.append(f"A{s - 1}.{m}")           # upstream activations
            tasks.append(Task(name=f"F{s}.{m}", kind="compute",
                              duration=st.fwd_time, executor=exec_name,
                              deps=tuple(fdeps)))
            if s + 1 < S:
                tasks.append(Task(name=f"A{s}.{m}", kind="comm",
                                  nbytes=st.comm_bytes_out,
                                  resources=down_route,
                                  net_latency=_lat(down_route),
                                  deps=(f"F{s}.{m}",)))
            if training:
                bdeps = [f"F{s}.{m}"]
                if s + 1 < S:
                    bdeps.append(f"G{s + 1}.{m}")       # downstream grads
                tasks.append(Task(name=f"B{s}.{m}", kind="compute",
                                  duration=st.bwd_time, executor=exec_name,
                                  deps=tuple(bdeps)))
                if s > 0:
                    # grad wrt inputs has the size of the *upstream boundary*
                    # activation (stage s-1's output), not this stage's output
                    tasks.append(Task(name=f"G{s}.{m}", kind="comm",
                                      nbytes=plan.stages[s - 1].comm_bytes_out,
                                      resources=up_route,
                                      net_latency=_lat(up_route),
                                      deps=(f"B{s}.{m}",)))
        if training and st.dp_degree > 1 and st.sync_bytes > 0:
            ar_route = _group_route(topo, st.devices)
            tasks.append(Task(name=f"AR{s}", kind="comm",
                              nbytes=st.sync_bytes * st.dp_degree,
                              resources=ar_route,
                              net_latency=_lat(ar_route),
                              deps=tuple(f"B{s}.{m}" for m in range(M))))
    return tasks


def cep_resource_caps(topo: Topology) -> Dict[str, float]:
    return {name: r.capacity for name, r in topo.resources.items()}


class CEPCache:
    """Per-plan CEP reuse: build the task graph once, derive everything
    else lazily and keep it.

    One ``refine`` used to expand the same plan into the same CEP graph
    and re-run ``assign_priorities`` up to 7 times (fair eval + every
    chunk mode + the LP lower bound); the runtime adapter then repeated
    all of it on every dynamics event.  This cache memoizes, per plan:

    * the base (unchunked) task list — built once;
    * each chunked variant (``chunk_comm_tasks`` clones of the cached
      base tasks) and its dependency structure/topological order;
    * the critical-path priority map per ``(chunks, caps)`` — priorities
      depend on resource capacities (bandwidth-scale events) but not on
      compute speed or comm mode.

    ``engine`` hands back a ready-to-``run`` :class:`EventEngine` with
    the cached structure and priorities applied.  Chunk counts ``w <= 1``
    share the base task list (the fair/null schedule and the unchunked
    scheduled search use the same graph).
    """

    def __init__(self, plan: ParallelismPlan, topo: Topology,
                 shared_structs: Optional[Dict[tuple, tuple]] = None):
        self.plan = plan
        self.topo = topo
        self._tasks: Dict[int, List[Task]] = {}
        self._structs: Dict[int, tuple] = {}
        self._dists: Dict[Tuple[int, tuple], Dict[str, float]] = {}
        self._applied: Dict[int, tuple] = {}    # w -> caps sig last applied
        self._runs: "OrderedDict[tuple, object]" = OrderedDict()
        # (succ, ndeps, order) keyed by CEP *shape*, shared across plans:
        # the dependency graph depends only on stage/microbatch counts
        # and which transfers exist — not on durations, byte sizes or
        # routes — so a candidate pool of like-shaped plans builds it once
        self._shared = shared_structs

    def _shape(self, w: int) -> tuple:
        p = self.plan
        return (w, len(p.stages), p.n_microbatches, p.training,
                tuple(s.comm_bytes_out > 0 for s in p.stages),
                tuple(p.training and s.dp_degree > 1 and s.sync_bytes > 0
                      for s in p.stages))

    def tasks(self, chunks: int = 1) -> List[Task]:
        w = max(int(chunks), 1)
        out = self._tasks.get(w)
        if out is None:
            if w == 1:
                out = build_cep(self.plan, self.topo)
            else:
                out = chunk_comm_tasks(self.tasks(1), w)
            self._tasks[w] = out
        return out

    def _structure(self, w: int) -> tuple:
        struct = self._structs.get(w)
        if struct is not None:
            return struct
        shape = self._shape(w) if self._shared is not None else None
        shared = self._shared.get(shape) if shape is not None else None
        if shared is not None:
            # same dependency graph, this plan's task objects
            struct = ({t.name: t for t in self.tasks(w)},) + shared
        else:
            if w == 1:
                struct = task_structure(self.tasks(1))
            else:       # derived from the base order in one linear walk
                struct = task_structure(self.tasks(w), base=self._structure(1))
            if shape is not None:
                self._shared[shape] = struct[1:]
        self._structs[w] = struct
        return struct

    def engine(self, chunks: int, caps: Dict[str, float],
               comm_mode: str = "scheduled",
               compute_speed: Optional[Dict[str, float]] = None
               ) -> EventEngine:
        w = max(int(chunks), 1)
        eng = EventEngine(self.tasks(w), caps, comm_mode=comm_mode,
                          compute_speed=compute_speed,
                          structure=self._structure(w))
        caps_sig = tuple(sorted(caps.items()))
        sig = (w, caps_sig)
        if self._applied.get(w) == caps_sig and sig in self._dists:
            return eng     # this task list already carries these priorities
        self._dists[sig] = eng.assign_priorities(self._dists.get(sig))
        # chunk variants share their non-comm Task objects with the base
        # list, so applying priorities for one w stales every other
        self._applied = {w: caps_sig}
        return eng

    def priorities(self, chunks: int, caps: Dict[str, float]
                   ) -> Dict[str, float]:
        """Critical-path priority map for one (chunk count, caps) pair
        (the ``lower_bound`` input), cached like :meth:`engine`'s."""
        sig = (max(int(chunks), 1), tuple(sorted(caps.items())))
        dist = self._dists.get(sig)
        if dist is None:
            self.engine(chunks, caps)
            dist = self._dists[sig]
        return dist

    def run(self, chunks: int, caps: Dict[str, float],
            comm_mode: str = "scheduled",
            compute_speed: Optional[Dict[str, float]] = None):
        """Memoized schedule execution: the engine is deterministic, so
        one ``(chunks, comm_mode, caps, speeds)`` configuration is
        simulated once and every repeat — the fair pre-ranking pass
        followed by ``refine``'s null schedule, or the adapter
        re-refining its Pareto set under unchanged conditions — returns
        the cached :class:`~repro_torch.core.engine.ScheduleResult`."""
        sig = (max(int(chunks), 1), comm_mode,
               tuple(sorted(caps.items())),
               tuple(sorted((compute_speed or {}).items())))
        res = self._runs.get(sig)
        if res is None:
            res = self.engine(chunks, caps, comm_mode, compute_speed).run()
            self._runs[sig] = res
            while len(self._runs) > 64:
                self._runs.popitem(last=False)
        else:
            self._runs.move_to_end(sig)
        return res
