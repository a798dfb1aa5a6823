# A copy of src/repro/core/cost_model.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Analytic cost model for Phase-1 planning (§4.1).

All times use the *contention-free peak p2p* network relaxation; Phase 2
re-evaluates the survivors under real contention. Costs are analytic
roofline estimates (compute-bound FLOP time ⊕ memory-bound byte time);
``DeviceProfile.compute_efficiency`` calibrates to measured MFU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Protocol, Sequence, Union, \
    runtime_checkable

from .device import Topology
from .planning_graph import ModelGraph
from .plans import ParallelismPlan, Stage
from . import profiler
from .qoe import QoESpec


DVFS_FLOOR = 0.15   # energy/FLOP at min frequency relative to peak (Fig. 3a)


def plan_device_energy(stages: Sequence[Stage], topo: Topology, n_micro: int,
                       training: bool, latency: float) -> Dict[int, float]:
    """Per-device energy for one iteration: compute + network tx + idle.

    Compute energy is DVFS-aware (the paper's Fig. 3a lever): a device
    that only needs fraction ``r`` of its peak rate to keep up with the
    plan runs at a lower voltage/frequency point, costing
    ``e_flop · (floor + (1-floor)·r²)`` per FLOP — slowing execution
    within QoE slack is what unlocks the order-of-magnitude savings the
    paper measures.

    The last stage's boundary activation is never transmitted; gradient
    return traffic is sized by the *upstream* boundary activation.
    """
    per_e: Dict[int, float] = {}
    S = len(stages)
    for idx, s in enumerate(stages):
        for d in s.devices:
            dev = topo.devices[d]
            share = s.microbatch_split[d]
            fl = (s.flops_fwd + s.flops_bwd) * n_micro * share / max(s.tp_degree, 1)
            busy = fl / dev.effective_flops(s.tp_degree)
            r = min(busy / max(latency, 1e-12), 1.0)
            dvfs = DVFS_FLOOR + (1.0 - DVFS_FLOOR) * r * r
            tx = s.sync_bytes
            if idx + 1 < S:
                tx += s.comm_bytes_out * n_micro * share          # activations down
            if training and idx > 0:
                tx += stages[idx - 1].comm_bytes_out * n_micro * share  # grads up
            e = dev.compute_energy(fl) * dvfs + dev.e_byte * tx \
                + dev.p_idle * latency
            per_e[d] = per_e.get(d, 0.0) + e
    return per_e


@dataclasses.dataclass(frozen=True)
class Workload:
    """One planning workload."""

    global_batch: int
    microbatch_size: int
    training: bool = True
    # training memory multiplier over bf16 params: grads + fp32 Adam m/v
    # (2 + 2 + 4 + 4 + 4)/2 = 8 over raw bf16 param bytes.
    optimizer_mult: float = 8.0
    # gradient-sync byte multiplier (0.25 = int8+EF compression on the
    # slow axis — see optim/compress.py)
    grad_compression: float = 1.0

    @property
    def n_microbatches(self) -> int:
        return max(1, self.global_batch // self.microbatch_size)


# The paper's §5 evaluation workloads — the single source of truth for
# the scenario catalogue (repro_torch.scenarios.catalog) and the benchmark
# harnesses (repro_torch.sim.runner.workload_for). Edge tuning keeps bf16
# params + grads + momentum → 3× param bytes of tuning state.
PAPER_TRAIN_WORKLOAD = Workload(global_batch=32, microbatch_size=4,
                                training=True, optimizer_mult=3.0)
PAPER_SERVE_WORKLOAD = Workload(global_batch=8, microbatch_size=1,
                                training=False)


@runtime_checkable
class CostProvider(Protocol):
    """Source of the costs every planner strategy consumes.

    Two fidelities share this protocol: :class:`AnalyticCosts` (pure
    datasheet rooflines, the Phase-1 default) and
    :class:`repro_torch.core.profiler.ProfiledCosts` (the same rooflines
    recalibrated by measured step times / kernel benchmarks).  A provider
    is injected with ``dora.plan(..., costs=...)`` or passed to any
    ``PlannerStrategy.plan``; consumers either ask for a ready
    :class:`CostModel` or calibrate a topology and keep using their own
    cost code on top of it.
    """

    name: str

    def calibrate(self, topo: Topology) -> Topology:
        """Topology with device/link rates adjusted to this provider's
        view of the hardware (identity for analytic costs).  ``topo`` is
        always the *raw* datasheet topology — calibration is not
        idempotent for measured providers, so never re-calibrate an
        already-calibrated topology."""
        ...

    def cost_model(self, graph: ModelGraph, topo: Topology,
                   workload: Workload) -> "CostModel":
        """A :class:`CostModel` pricing ``graph`` for ``workload``.
        ``topo`` is the *raw* topology; the provider calibrates it
        internally (do not pass ``calibrate(topo)`` here)."""
        ...


@dataclasses.dataclass(frozen=True)
class AnalyticCosts:
    """The default provider: roofline costs straight from the
    ``DeviceProfile``/``LinkResource`` datasheet numbers."""

    name: str = "analytic"

    def calibrate(self, topo: Topology) -> Topology:
        return topo

    def cost_model(self, graph: ModelGraph, topo: Topology,
                   workload: Workload) -> "CostModel":
        return CostModel(graph, topo, workload)


#: Shared default instance (stateless, safe to reuse).
ANALYTIC_COSTS = AnalyticCosts()


#: ``costs=`` accepts a provider instance or a string reference:
#: ``"analytic"`` or ``"profiled:<path/to/artifact.json>"``.
CostRef = Union[None, str, CostProvider]


def resolve_costs(costs: CostRef) -> CostProvider:
    """``None`` -> the analytic default; a string resolves a named
    provider (``"analytic"``, ``"profiled:<path>"`` — a committed
    :meth:`ProfiledCosts.to_json` artifact); instances pass through."""
    if costs is None:
        return ANALYTIC_COSTS
    if isinstance(costs, str):
        if costs == "analytic":
            return ANALYTIC_COSTS
        if costs.startswith("profiled:"):
            from .profiler import ProfiledCosts
            return ProfiledCosts.from_json(costs[len("profiled:"):])
        raise ValueError(f"unknown cost provider {costs!r}: expected "
                         f"'analytic' or 'profiled:<path>'")
    return costs


class SegmentAggregates:
    """O(1) pricing of contiguous segments of a serialized node order.

    The partitioner's DP prices O(L²·N²) candidate stages, every one of
    which is a *contiguous* slice of one fixed serialization of the
    planning graph (chain slices, and bundles of adjacent chains).  This
    class memoizes the per-segment sums :meth:`CostModel.make_stage`
    needs — forward/backward FLOPs and parameter bytes — so each
    distinct segment is summed once and every repeat costs O(1).

    Sums are accumulated left-to-right exactly like ``sum(...)`` over
    the slice, so segment prices are bit-identical to the naive path
    (plan-parity golden tests depend on this).
    """

    __slots__ = ("order", "_nodes", "_memo")

    def __init__(self, graph: ModelGraph, order: Sequence[int]):
        self.order = list(order)
        self._nodes = [graph.nodes[i] for i in self.order]
        # (lo, hi) -> (flops_fwd, flops_bwd, param_bytes, state_bytes)
        # for order[lo:hi]
        self._memo: Dict[tuple, tuple] = {}

    def segment(self, lo: int, hi: int) -> tuple:
        """(flops_fwd, flops_bwd, param_bytes, state_bytes) summed over
        order[lo:hi]."""
        if hi <= lo:
            return (0.0, 0.0, 0.0, 0.0)
        memo = self._memo
        out = memo.get((lo, hi))
        if out is not None:
            return out
        h = hi - 1
        while h > lo and (lo, h) not in memo:
            h -= 1
        ff, fb, pb, sb = memo[(lo, h)] if h > lo else (0.0, 0.0, 0.0, 0.0)
        while h < hi:
            n = self._nodes[h]
            ff, fb, pb, sb = (ff + n.flops_fwd, fb + n.flops_bwd,
                              pb + n.param_bytes, sb + n.state_bytes)
            h += 1
            memo[(lo, h)] = (ff, fb, pb, sb)
        return memo[(lo, hi)]

    def boundary_act_bytes(self, hi: int) -> float:
        """Per-sample output-activation bytes of segment-final node
        ``order[hi-1]`` (the stage's downstream boundary)."""
        return self._nodes[hi - 1].act_bytes


class CostModel:
    def __init__(self, graph: ModelGraph, topo: Topology, workload: Workload):
        self.graph = graph
        self.topo = topo
        self.wl = workload
        self._eff: Dict[tuple, float] = {}      # (device, tp) -> eff FLOP/s

    # -- stage construction ----------------------------------------------------
    def make_stage(self, node_ids: Sequence[int], devices: Sequence[int],
                   next_devices: Optional[Sequence[int]] = None) -> Stage:
        b = self.wl.microbatch_size
        nodes = [self.graph.nodes[i] for i in node_ids]
        flops_f = sum(n.flops_fwd for n in nodes) * b
        flops_b = sum(n.flops_bwd for n in nodes) * b if self.wl.training else 0.0
        params = sum(n.param_bytes for n in nodes)
        boundary_act = nodes[-1].act_bytes * b
        state = sum(n.state_bytes for n in nodes)
        return self._build_stage(list(node_ids), flops_f, flops_b, params,
                                 boundary_act, state, devices, next_devices)

    def make_stage_span(self, agg: SegmentAggregates, lo: int, hi: int,
                        devices: Sequence[int],
                        next_devices: Optional[Sequence[int]] = None) -> Stage:
        """``make_stage`` for the contiguous segment ``agg.order[lo:hi]``,
        priced in O(1) from the memoized prefix aggregates."""
        b = self.wl.microbatch_size
        ff, fb, pb, sb = agg.segment(lo, hi)
        flops_f = ff * b
        flops_b = fb * b if self.wl.training else 0.0
        boundary_act = agg.boundary_act_bytes(hi) * b
        return self._build_stage(agg.order[lo:hi], flops_f, flops_b, pb,
                                 boundary_act, sb, devices, next_devices)

    def _build_stage(self, node_ids: List[int], flops_f: float, flops_b: float,
                     params: float, boundary_act: float, state: float,
                     devices: Sequence[int],
                     next_devices: Optional[Sequence[int]]) -> Stage:
        devs = list(devices)
        tp = 1
        if len(devs) == 1:
            tp = self.topo.devices[devs[0]].n_accel
        eff = self._eff
        speeds = {}
        for d in devs:
            v = eff.get((d, tp))
            if v is None:
                v = self.topo.devices[d].effective_flops(tp)
                eff[(d, tp)] = v
            speeds[d] = v
        total_speed = sum(speeds.values())
        split = {d: speeds[d] / total_speed for d in devs}

        # balanced execution time: every replica finishes together when
        # microbatches are split ∝ speed (§4.1 load-balance rule).
        # Per-device roofline: FLOP time ⊕ weight-streaming time (every DP
        # replica reads the full stage weights once per microbatch — the
        # dominant term for small-batch serving).
        w_read = params / max(tp, 1)
        t_f = max(flops_f / total_speed,
                  max(w_read / self.topo.devices[d].mem_bw for d in devs))
        t_b = max(flops_b / total_speed,
                  max(2.0 * w_read / self.topo.devices[d].mem_bw for d in devs)) \
            if self.wl.training else 0.0

        # activation send to the next stage at peak p2p bandwidth
        send_t = 0.0
        if next_devices:
            pairs = [(i, j) for i in devs for j in next_devices if i != j]
            if pairs:
                bw = min(self.topo.peak_bandwidth(i, j) for i, j in pairs)
                lat = max(self.topo.route_latency(i, j) for i, j in pairs)
                send_t = lat + boundary_act / bw

        sync_bytes = 0.0
        if self.wl.training and len(devs) > 1:
            g = len(devs)
            sync_bytes = 2.0 * params * (g - 1) / g \
                * self.wl.grad_compression              # ring all-reduce per device

        return Stage(node_ids=node_ids, devices=devs, microbatch_split=split,
                     tp_degree=tp, fwd_time=t_f + send_t, bwd_time=t_b + send_t,
                     comm_bytes_out=boundary_act, sync_bytes=sync_bytes,
                     param_bytes=params, flops_fwd=flops_f, flops_bwd=flops_b,
                     state_bytes=state)

    # -- memory ------------------------------------------------------------------
    def stage_memory(self, stage: Stage, n_stages_hint: int = 1,
                     schedule: str = "1f1b") -> Dict[int, float]:
        """Per-device bytes for a stage: params (+optimizer) + in-flight
        activations. 1F1B holds ≤ n_stages microbatches of activations."""
        mult = self.wl.optimizer_mult if self.wl.training else 1.0
        params_per_dev = stage.param_bytes * mult / max(stage.tp_degree, 1)
        in_flight = min(self.wl.n_microbatches, n_stages_hint) if schedule == "1f1b" \
            else self.wl.n_microbatches
        act = stage.comm_bytes_out * in_flight
        state = stage.state_bytes
        if state is None:       # hand-built Stage: fall back to the graph
            state = sum(self.graph.nodes[i].state_bytes for i in stage.node_ids)
        state = state * self.wl.microbatch_size
        out = {}
        for d in stage.devices:
            out[d] = params_per_dev + act * stage.microbatch_split[d] + state
        return out

    def memory_feasible(self, stage: Stage, qoe: QoESpec, n_stages_hint: int = 4) -> bool:
        mem = self.stage_memory(stage, n_stages_hint)
        for d, used in mem.items():
            cap = self.topo.devices[d].memory
            if qoe.m_qoe is not None:
                cap = min(cap, qoe.m_qoe)
            if used > cap:
                return False
        return True

    # -- full-plan evaluation (contention-free) -----------------------------------
    def boundary_comm_times(self, stages: List[Stage]) -> List[float]:
        """Per-boundary activation/gradient transfer time at peak p2p bw."""
        out: List[float] = []
        for a, b_ in zip(stages[:-1], stages[1:]):
            pairs = [(i, j) for i in a.devices for j in b_.devices if i != j]
            if not pairs:
                out.append(0.0)
                continue
            bw = min(self.topo.peak_bandwidth(i, j) for i, j in pairs)
            lat = max(self.topo.route_latency(i, j) for i, j in pairs)
            out.append(lat + a.comm_bytes_out / bw)
        return out

    def evaluate(self, stages: List[Stage], qoe: QoESpec,
                 schedule: str = "1f1b") -> ParallelismPlan:
        M = self.wl.n_microbatches
        bf = [s.fwd_time for s in stages]
        bb = [s.bwd_time for s in stages]
        comm = self.boundary_comm_times(stages)
        if self.wl.training:
            if schedule == "gpipe":
                lat = profiler.gpipe_latency(bf, bb, M, comm, comm)
            else:
                lat = profiler.one_f_one_b_latency(bf, bb, M, comm, comm)
            # gradient sync after the flush (phase-1: non-overlapped bound)
            sync_t = 0.0
            for s in stages:
                if s.sync_bytes > 0.0:
                    bw = min(self.topo.peak_bandwidth(i, j)
                             for i in s.devices for j in s.devices if i != j)
                    sync_t = max(sync_t, s.sync_bytes / bw)
            lat += sync_t
        else:
            # inference: forward wave only
            lat = profiler.gpipe_latency(bf, [0.0] * len(bf), M, comm, comm)

        per_e = plan_device_energy(stages, self.topo, M, self.wl.training, lat)
        per_m: Dict[int, float] = {}
        for s in stages:
            mem = self.stage_memory(s, len(stages), schedule)
            for d in s.devices:
                per_m[d] = max(per_m.get(d, 0.0), mem[d])

        energy = sum(per_e.values())
        plan = ParallelismPlan(
            stages=stages, microbatch_size=self.wl.microbatch_size,
            n_microbatches=M, training=self.wl.training, latency=lat,
            energy=energy, per_device_energy=per_e, per_device_memory=per_m,
            objective=qoe.objective(energy, lat))
        return plan
