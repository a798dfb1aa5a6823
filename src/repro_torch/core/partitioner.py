# A copy of src/repro/core/partitioner.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Phase 1 — heterogeneity- and QoE-aware model partitioner (§4.1).

Graph-level dynamic programming over the serial-decomposed planning
graph, per Eqs. (3)-(5):

  Q1(j,l,s,n) — first j-1 chains + first l layers of chain j in s stages
                on the first n devices;
  Q2(j,k,s,n) — chains k..j bundled into one stage, preceding k-1 chains
                in s-1 stages, all on the first n devices;
  Q(j,s,n)    — min(Q1(j,L_j,s,n), min_k Q2(j,k,s,n)).

Every DP cell keeps the **top-K** partial plans (the paper's insight:
the contention-aware optimum stays near the top of the contention-free
ranking), evaluated with the Lagrangian objective of Eq. (2).

Hot-path structure (plan-parity preserving — golden tests lock the
output): every candidate stage is a contiguous slice of one fixed
serialization of the chains, so stages are priced in O(1) via
:class:`~.cost_model.SegmentAggregates` prefix sums and cached by
``(segment span, device span)``; DP cells are bounded max-heaps keyed
on the partial's precomputed objective (plus an insertion counter that
reproduces the old stable-sort tie order exactly); and because the
objective is monotone under extension, a partial whose own key already
exceeds a full cell's K-th best is pruned without pricing the child
(the cells are read in ascending key order, so the scan breaks early).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import CostModel, SegmentAggregates, Workload
from .device import Topology
from .planning_graph import ModelGraph
from .plans import ParallelismPlan, Stage
from .qoe import QoESpec


class _StageInfo:
    """One feasible candidate stage, as the scalars the DP loop reads:
    per-microbatch time, energy (for the workload's microbatch count),
    contention-free gradient-sync time, boundary activation bytes, the
    (segment, device-block) spans, and ``min_key`` — a lower bound on
    the key of *any* partial ending in this stage (the objective is
    monotone, so a stage whose bound already exceeds a full cell's K-th
    best prunes every extension).  The scalars come from the vectorized
    segment×block tables; the actual :class:`Stage` object is only
    materialized (``stage``) for partials that reach the final ranking.
    """

    __slots__ = ("stage", "lo", "hi", "n0", "n1", "t", "energy", "sync_t",
                 "comm_out", "min_key")

    def __init__(self, lo: int, hi: int, n0: int, n1: int, t: float,
                 energy: float, sync_t: float, comm_out: float,
                 min_key: float):
        self.stage: Optional[Stage] = None
        self.lo = lo
        self.hi = hi
        self.n0 = n0
        self.n1 = n1
        self.t = t
        self.energy = energy
        self.sync_t = sync_t
        self.comm_out = comm_out
        self.min_key = min_key


class _Partial:
    """One DP partial plan (plain ``__slots__`` class: these are created
    tens of thousands of times per planning call)."""

    __slots__ = ("stages", "comm_sum", "energy", "sum_t", "max_t", "sync_t",
                 "key", "seq", "last")

    def __init__(self, stages: Tuple[_StageInfo, ...], comm_sum: float,
                 energy: float, sum_t: float, max_t: float, sync_t: float,
                 key: float, seq: int, last: Optional[_StageInfo]):
        self.stages = stages
        self.comm_sum = comm_sum    # Σ per-boundary activation transfer times
        self.energy = energy        # running compute+comm energy estimate
        self.sum_t = sum_t          # Σ (bf+bb) over stages
        self.max_t = max_t          # max (bf+bb) over stages
        self.sync_t = sync_t        # max contention-free gradient-sync time
        self.key = key              # ranking objective (monotone under extend)
        self.seq = seq              # creation counter: stable tie order
        self.last = last            # info of the final stage (comm pricing)


@dataclasses.dataclass
class PartitionerConfig:
    top_k: int = 4
    max_stages: Optional[int] = None
    delta: float = 0.05                       # Δ-merge threshold
    schedule: str = "1f1b"
    device_orderings: Sequence[str] = ("fast_first", "slow_first")
    microbatch_sizes: Sequence[int] = ()      # empty -> use workload's
    objective_mode: str = "e2e"               # "e2e" (Dora) | "throughput" (L2 baselines)


class ModelPartitioner:
    def __init__(self, graph: ModelGraph, topo: Topology, qoe: QoESpec,
                 config: Optional[PartitionerConfig] = None):
        self.config = config or PartitionerConfig()
        self.raw_graph = graph
        self.graph = graph.compress(self.config.delta)
        self.topo = topo
        self.qoe = qoe
        self.chains = self.graph.serial_decompose()
        # fixed serialization of the chains: every DP stage (chain slice
        # or bundle of adjacent chains) is a contiguous span of it
        self._serial: List[int] = [i for c in self.chains for i in c]
        self._offs: List[int] = [0]
        for c in self.chains:
            self._offs.append(self._offs[-1] + len(c))
        self._agg = SegmentAggregates(self.graph, self._serial)
        # pairwise peak-bandwidth matrix (lazy): DP block-min inputs
        self._peak_bw: Dict[Tuple[int, int], float] = {}

    # -- public ------------------------------------------------------------------
    def plan(self, workload: Workload,
             pool: bool = False) -> List[ParallelismPlan]:
        """Return the top-K QoE-compliant candidate plans (Alg. 1 lines 2-3).

        ``pool=True`` returns the wider DP pool (≤ 8·K plans) for Phase-2
        re-ranking under real contention — the paper's 'tunable search
        space' knob (Fig. 13)."""
        mb_sizes = list(self.config.microbatch_sizes) or [workload.microbatch_size]
        candidates: List[ParallelismPlan] = []
        for mb in mb_sizes:
            if workload.global_batch % mb:
                continue
            wl = dataclasses.replace(workload, microbatch_size=mb)
            candidates.extend(self._plan_one(wl))
        candidates.sort(key=self._rank_key)
        candidates = self._dedupe(candidates)
        if pool:
            return self._diverse_top(candidates, 8 * self.config.top_k)
        return self._diverse_top(candidates, self.config.top_k)

    def _rank_key(self, p: ParallelismPlan) -> float:
        if self.config.objective_mode == "throughput":
            # rate-optimal ranking: steady-state iteration time =
            # microbatches × bottleneck stage + contention-free gradient
            # sync. Blind to pipeline fill/drain, per-message latency and
            # link contention — the L2 failure mode.
            bott = max(s.fwd_time + s.bwd_time for s in p.stages)
            sync = 0.0
            for s in p.stages:
                if s.sync_bytes > 0 and s.dp_degree > 1:
                    bw = min(self.topo.peak_bandwidth(i, j)
                             for i in s.devices for j in s.devices if i != j)
                    sync = max(sync, s.sync_bytes / bw)
            return p.n_microbatches * bott + sync
        return p.objective

    @staticmethod
    def _diverse_top(plans: List[ParallelismPlan], k: int) -> List[ParallelismPlan]:
        """Top-K candidate selection. The contention-free ranking is only a
        *proxy* (§4.1 — the real-network optimum stays 'near the top'), so
        half the K slots take the outright best plans (rank inversions
        happen within a shape class too) and half cover distinct plan
        shapes (stage count × max DP width × device count × microbatch).
        Phase 2 re-ranks everything under true contention."""
        head = plans[: max(k // 2, 1)]
        chosen = {id(p) for p in head}
        sigs = {(p.n_stages, max(s.dp_degree for s in p.stages),
                 len(set(p.devices)), p.microbatch_size) for p in head}
        out = list(head)
        for p in plans:                       # fill with unseen shapes
            if len(out) >= k:
                break
            sig = (p.n_stages, max(s.dp_degree for s in p.stages),
                   len(set(p.devices)), p.microbatch_size)
            if sig in sigs or id(p) in chosen:
                continue
            out.append(p)
            chosen.add(id(p))
            sigs.add(sig)
        for p in plans:                       # densify with runners-up
            if len(out) >= k:
                break
            if id(p) not in chosen:
                out.append(p)
                chosen.add(id(p))
        return out

    # -- DP ----------------------------------------------------------------------
    def _plan_one(self, wl: Workload) -> List[ParallelismPlan]:
        cm = CostModel(self.graph, self.topo, wl)
        out: List[ParallelismPlan] = []
        for ordering in self.config.device_orderings:
            devices = self._order_devices(ordering)
            out.extend(self._dp(cm, wl, devices))
        return out

    def _order_devices(self, ordering: str) -> List[int]:
        idx = list(range(self.topo.n))
        speed = lambda d: self.topo.devices[d].effective_flops()
        if ordering == "fast_first":
            idx.sort(key=speed, reverse=True)
        elif ordering == "slow_first":
            idx.sort(key=speed)
        return idx

    def _pair_bw(self, i: int, j: int) -> float:
        bw = self._peak_bw.get((i, j))
        if bw is None:
            bw = self.topo.peak_bandwidth(i, j)
            self._peak_bw[(i, j)] = bw
        return bw

    def _dp(self, cm: CostModel, wl: Workload, dev_order: List[int]) -> List[ParallelismPlan]:
        K = self.config.top_k
        N = len(dev_order)
        J = len(self.chains)
        S_max = self.config.max_stages or min(N, len(self.graph.nodes))
        M = wl.n_microbatches
        qoe = self.qoe
        mode = self.config.objective_mode
        offs = self._offs
        agg = self._agg
        stage_cache: Dict[Tuple[int, int, int, int], Optional[_StageInfo]] = {}
        cross_bw: Dict[Tuple[int, int, int, int], float] = {}
        intra_bw: Dict[Tuple[int, int], float] = {}
        seq = 0

        if mode == "throughput":
            def key_of(energy: float, sum_t: float, max_t: float,
                       comm_sum: float, sync_t: float) -> float:
                # cloud-planner objective (L2): steady-state iteration
                # rate — bottleneck stage + contention-free sync;
                # pipeline fill/drain, per-message latency and
                # contention are invisible to it.
                return M * max_t + sync_t
        else:
            # Eq. (2) inlined (`qoe.objective` on the contention-free
            # latency estimate): the λ·0 branch is algebraically the
            # bare energy, so the values are bit-identical
            lam, t_qoe = qoe.lam, qoe.t_qoe

            def key_of(energy: float, sum_t: float, max_t: float,
                       comm_sum: float, sync_t: float) -> float:
                lat_est = (M - 1) * max_t + sum_t + 2 * comm_sum
                if lat_est > t_qoe:
                    return energy + lam * (lat_est - t_qoe)
                return energy

        def block(n0: int, n1: int) -> List[int]:
            return [dev_order[i] for i in range(n0, n1)]

        def block_pair_bw(a0: int, a1: int, b0: int, b1: int) -> float:
            """min peak bandwidth across two disjoint device blocks."""
            bw = cross_bw.get((a0, a1, b0, b1))
            if bw is None:
                bw = min(self._pair_bw(i, j)
                         for i in dev_order[a0:a1] for j in dev_order[b0:b1])
                cross_bw[(a0, a1, b0, b1)] = bw
            return bw

        mem_mult = wl.optimizer_mult if wl.training else 1.0
        training = wl.training
        b = wl.microbatch_size
        gc = wl.grad_compression
        devices = self.topo.devices
        m_qoe = qoe.m_qoe
        in_flight = min(M, 4)       # memory_feasible's n_stages_hint=4, 1f1b
        Lt = len(self._serial)
        W = Lt + 1                  # flat segment index: lo * W + hi

        # -- vectorized segment×block stage tables --------------------------
        # Every candidate stage's scalars (time, energy, sync time, memory
        # feasibility, pruning bound) are computed for ALL segments of a
        # device block in one numpy pass, bit-identical to pricing each
        # stage through `CostModel._build_stage` + `_stage_energy` +
        # `memory_feasible`: per-device reductions stay scalar loops in
        # device order (preserving float association) and only the
        # segment dimension is vectorized.  Stage *objects* are no longer
        # built during the DP at all — see the finals materialization.
        ffb = np.zeros(W * W)       # flops_fwd · b   per segment
        fbb = np.zeros(W * W)       # flops_bwd · b   (zeros when serving)
        pb_ = np.zeros(W * W)       # param bytes     per segment
        actb = np.zeros(W * W)      # boundary activation · b
        stmem = np.zeros(W * W)     # state bytes · b (stage_memory's term)
        for lo in range(Lt):
            for hi in range(lo + 1, Lt + 1):
                ff, fb, pb, sb = agg.segment(lo, hi)
                i = lo * W + hi
                ffb[i] = ff * b
                if training:
                    fbb[i] = fb * b
                pb_[i] = pb
                actb[i] = agg.boundary_act_bytes(hi) * b
                stmem[i] = sb * b
        flo = ffb + fbb             # flops_fwd + flops_bwd (stage fields)
        act_mem = actb * in_flight  # in-flight activation bytes
        act_m = actb * M            # per-iteration activation traffic

        tables: Dict[Tuple[int, int], tuple] = {}

        def block_table(n0: int, n1: int) -> tuple:
            """(t, energy, sync_t, min_key, feasible) lists over the flat
            segment index, for stages on device block (n0, n1)."""
            tb = tables.get((n0, n1))
            if tb is not None:
                return tb
            devs = [dev_order[i] for i in range(n0, n1)]
            g = len(devs)
            tp = devices[devs[0]].n_accel if g == 1 else 1
            tp_ = max(tp, 1)
            eff = cm._eff
            speeds = []
            for d in devs:
                v = eff.get((d, tp))
                if v is None:
                    v = devices[d].effective_flops(tp)
                    eff[(d, tp)] = v
                speeds.append(v)
            total = sum(speeds)
            split = [v / total for v in speeds]
            membw = min(devices[d].mem_bw for d in devs)
            # time: roofline max over devices == division by the block's
            # min memory bandwidth (monotone float division)
            w_read = pb_ / tp_
            t = np.maximum(ffb / total, w_read / membw)
            if training:
                t = t + np.maximum(fbb / total, 2.0 * w_read / membw)
            # gradient-sync bytes/time (ring all-reduce per device)
            if training and g > 1:
                sy = 2.0 * pb_ * (g - 1) / g * gc
                bw = intra_bw.get((n0, n1))
                if bw is None:
                    bw = min(self._pair_bw(i, j)
                             for i in devs for j in devs if i != j)
                    intra_bw[(n0, n1)] = bw
                sy_t = np.where(sy > 0.0, sy / bw, 0.0)
            else:
                sy = np.zeros(W * W)
                sy_t = sy
            # energy (`_stage_energy`): two adds per device, device order
            e = np.zeros(W * W)
            for d, share in zip(devs, split):
                dev = devices[d]
                e = e + flo * M * share / tp_ * dev.e_flop
                e = e + dev.e_byte * (act_m * share + sy)
            # memory feasibility (`stage_memory` at n_stages_hint=4)
            ppd = pb_ * mem_mult / tp_
            feas = np.ones(W * W, dtype=bool)
            for d, share in zip(devs, split):
                cap = devices[d].memory
                if m_qoe is not None:
                    cap = min(cap, m_qoe)
                feas &= ~(ppd + act_mem * share + stmem > cap)
            # min_key: key_of(energy, t, t, 0, 0) — a floor for any
            # partial ending in this stage
            if mode == "throughput":
                mk = M * t + sy_t
            else:
                lat = (M - 1) * t + t
                mk = np.where(lat > t_qoe, e + lam * (lat - t_qoe), e)
            tb = (t.tolist(), e.tolist(), sy_t.tolist(), mk.tolist(),
                  feas.tolist())
            tables[(n0, n1)] = tb
            return tb

        act_list = actb.tolist()

        def stage_info(lo: int, hi: int, n0: int, n1: int
                       ) -> Optional[_StageInfo]:
            key = (lo, hi, n0, n1)
            info = stage_cache.get(key, False)
            if info is not False:
                return info
            t, e, sy_t, mk, feas = block_table(n0, n1)
            i = lo * W + hi
            if not feas[i]:
                info = None
            else:
                info = _StageInfo(lo, hi, n0, n1, t[i], e[i], sy_t[i],
                                  act_list[i], mk[i])
            stage_cache[key] = info
            return info

        heappush, heapreplace = heapq.heappush, heapq.heapreplace

        def extend_cell(cell: List[tuple], src: List[_Partial],
                        info: _StageInfo) -> None:
            """Push every useful extension of ``src``'s partials by
            ``info`` into the bounded max-heap ``cell``.

            The cell keeps the K best partials by (key, creation order)
            — the same set and tie order a sort-per-insert kept, at
            O(log K) per insert — and children are only *materialized*
            (stage-tuple concat + dataclass) once their key is known to
            make the cut.  ``src`` is key-sorted and the key is monotone
            under extension, so the scan breaks at the first partial
            that can no longer beat the cell's K-th best.
            """
            nonlocal seq
            for p in src:
                full = len(cell) == K
                if full:
                    worst = -cell[0][0]
                    if p.key >= worst or info.min_key >= worst:
                        break
                comm_sum = p.comm_sum
                last = p.last
                if last is not None:
                    comm_sum = comm_sum + last.comm_out / block_pair_bw(
                        last.n0, last.n1, info.n0, info.n1)
                sync_t = p.sync_t if info.sync_t <= p.sync_t else info.sync_t
                e = p.energy + info.energy
                t = info.t
                sum_t = p.sum_t + t
                max_t = p.max_t if t <= p.max_t else t
                k = key_of(e, sum_t, max_t, comm_sum, sync_t)
                seq += 1
                negk = -k
                if not full:
                    heappush(cell, (negk, -seq, _Partial(
                        p.stages + (info,), comm_sum, e, sum_t, max_t,
                        sync_t, k, seq, info)))
                elif negk > cell[0][0]:
                    # ties on key never displace: the incumbent was
                    # created earlier (smaller seq) and wins the tiebreak
                    heapreplace(cell, (negk, -seq, _Partial(
                        p.stages + (info,), comm_sum, e, sum_t, max_t,
                        sync_t, k, seq, info)))

        def finalize(cell: List[tuple]) -> List[_Partial]:
            cell.sort(reverse=True)           # (key, seq) ascending
            return [it[2] for it in cell]

        empty = _Partial((), 0.0, 0.0, 0.0, 0.0, 0.0,
                         key_of(0.0, 0.0, 0.0, 0.0, 0.0), 0, None)
        # Q[(j, s, n)] / Q1[(j, l, s, n)] hold the top-K partials, in
        # ascending (key, seq) order
        Q: Dict[Tuple[int, int, int], List[_Partial]] = \
            {(0, 0, n): [empty] for n in range(N + 1)}
        final: List[_Partial] = []

        for j in range(1, J + 1):
            off = offs[j - 1]
            L = offs[j] - off
            Q1: Dict[Tuple[int, int, int], List[_Partial]] = {}
            for s in range(0, S_max + 1):
                for n in range(0, N + 1):
                    # base: Q1(j, 0, s, n) = Q(j-1, s, n)
                    prev = Q.get((j - 1, s, n))
                    if prev:
                        Q1[(0, s, n)] = prev
            for s in range(1, S_max + 1):
                for n in range(1, N + 1):
                    for l in range(1, L + 1):
                        cell: List[tuple] = []
                        # Eq. (3): extend with a stage of layers l'+1..l on devices n'+1..n
                        for lp in range(0, l):
                            for np_ in range(0, n):
                                src = Q1.get((lp, s - 1, np_))
                                if not src:
                                    continue
                                if len(cell) == K and src[0].key >= -cell[0][0]:
                                    continue    # even src's best is pruned
                                info = stage_info(off + lp, off + l, np_, n)
                                if info is not None:
                                    extend_cell(cell, src, info)
                        if cell:
                            Q1[(l, s, n)] = finalize(cell)
                    # Eq. (4)+(5): Q(j, s, n)
                    base = Q1.get((L, s, n))
                    qcell: List[tuple] = \
                        [(-p.key, -p.seq, p) for p in base] if base else []
                    heapq.heapify(qcell)
                    for k in range(1, j + 1):
                        for np_ in range(0, n):
                            src = Q.get((k - 1, s - 1, np_))
                            if not src:
                                continue
                            if len(qcell) == K and src[0].key >= -qcell[0][0]:
                                continue
                            info = stage_info(offs[k - 1], offs[j], np_, n)
                            if info is not None:
                                extend_cell(qcell, src, info)
                    if qcell:
                        Q[(j, s, n)] = finalize(qcell)
            # allow chain j to end at any s/n — final candidates come from j == J
        for s in range(1, S_max + 1):
            for n in range(1, N + 1):
                final.extend(Q.get((J, s, n), ()))

        plans: List[ParallelismPlan] = []
        for p in final:
            if not p.stages:
                continue
            # materialize the real Stage objects (shared across partials
            # that picked the same segment×block, like the old per-DP
            # stage cache) only for partials that reached the finals
            stages: List[Stage] = []
            for inf in p.stages:
                st = inf.stage
                if st is None:
                    st = cm.make_stage_span(agg, inf.lo, inf.hi,
                                            block(inf.n0, inf.n1))
                    inf.stage = st
                stages.append(st)
            plan = cm.evaluate(stages, qoe, self.config.schedule)
            plan.meta["dev_order"] = tuple(dev_order)
            plans.append(plan)
        plans.sort(key=self._rank_key)
        return plans[: 4 * K]

    def _stage_energy(self, st: Stage, n_micro: int) -> float:
        e = 0.0
        for d in st.devices:
            dev = self.topo.devices[d]
            share = st.microbatch_split[d]
            fl = (st.flops_fwd + st.flops_bwd) * n_micro * share / max(st.tp_degree, 1)
            e += dev.compute_energy(fl)
            e += dev.e_byte * (st.comm_bytes_out * n_micro * share + st.sync_bytes)
        return e

    @staticmethod
    def _dedupe(plans: List[ParallelismPlan]) -> List[ParallelismPlan]:
        seen = set()
        out = []
        for p in plans:
            sig = tuple((tuple(s.node_ids), tuple(s.devices)) for s in p.stages) \
                + (p.microbatch_size,)
            if sig in seen:
                continue
            seen.add(sig)
            out.append(p)
        return out
