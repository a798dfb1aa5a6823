# A copy of src/repro/core/profiler.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Pipeline-latency estimators.

``gpipe_latency``/``one_f_one_b_latency`` compute the *exact* critical
path of the respective microbatch schedules by dynamic programming over
(stage, microbatch) cells; the paper's Appendix Algorithm 2
(StartPhaseTimeEst / EndPhaseTimeEst) is implemented literally in
``alg2_start_phase`` / ``alg2_end_phase`` and validated against the
exact evaluators in tests.

:class:`ProfiledCosts` is the measured counterpart to
``core.cost_model.AnalyticCosts``: both implement the ``CostProvider``
protocol, so any planner strategy can be fed kernel-/step-measured
rates instead of datasheet rooflines (``dora.plan(..., costs=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple


def gpipe_latency(bf: Sequence[float], bb: Sequence[float], n_micro: int,
                  comm_f: Sequence[float] = (), comm_b: Sequence[float] = ()) -> float:
    """Exact GPipe (all-forward, then all-backward) iteration latency.

    ``bf[s]``/``bb[s]`` — per-microbatch forward/backward compute time of
    stage ``s``; ``comm_f[s]`` — activation transfer time from stage s to
    s+1 (len S-1); ``comm_b[s]`` — gradient transfer time s+1 -> s.
    """
    S = len(bf)
    if S == 0 or n_micro == 0:
        return 0.0
    cf = list(comm_f) if comm_f else [0.0] * (S - 1)
    cb = list(comm_b) if comm_b else [0.0] * (S - 1)
    # forward wave
    f = [[0.0] * n_micro for _ in range(S)]
    for m in range(n_micro):
        for s in range(S):
            ready = 0.0
            if s > 0:
                ready = f[s - 1][m] + cf[s - 1]
            if m > 0:
                ready = max(ready, f[s][m - 1])
            f[s][m] = ready + bf[s]
    # backward wave (reverse stage order), starts after last fwd on last stage
    b = [[0.0] * n_micro for _ in range(S)]
    for m in range(n_micro):
        for s in range(S - 1, -1, -1):
            if s == S - 1:
                ready = f[s][n_micro - 1] if m == 0 else b[s][m - 1]
                ready = max(ready, f[s][m])
            else:
                ready = b[s + 1][m] + cb[s]
                if m > 0:
                    ready = max(ready, b[s][m - 1])
                ready = max(ready, f[s][m])
            b[s][m] = ready + bb[s]
    return b[0][n_micro - 1]


def one_f_one_b_latency(bf: Sequence[float], bb: Sequence[float], n_micro: int,
                        comm_f: Sequence[float] = (), comm_b: Sequence[float] = ()) -> float:
    """Exact 1F1B (PipeDream-flush) iteration latency via event DP.

    Each stage s runs ``min(S - s, n_micro)`` warm-up forwards then
    alternates 1F1B; we simulate per-stage instruction streams exactly.
    """
    S = len(bf)
    if S == 0 or n_micro == 0:
        return 0.0
    cf = list(comm_f) if comm_f else [0.0] * (S - 1)
    cb = list(comm_b) if comm_b else [0.0] * (S - 1)

    # instruction streams
    streams: List[List[tuple]] = []
    for s in range(S):
        warm = min(S - s, n_micro)
        ops: List[tuple] = [("F", m) for m in range(warm)]
        fm, bm = warm, 0
        while bm < n_micro:
            ops.append(("B", bm)); bm += 1
            if fm < n_micro:
                ops.append(("F", fm)); fm += 1
        streams.append(ops)

    f_done = [[None] * n_micro for _ in range(S)]
    b_done = [[None] * n_micro for _ in range(S)]
    dev_free = [0.0] * S
    ptr = [0] * S
    remaining = sum(len(x) for x in streams)
    while remaining:
        progressed = False
        for s in range(S):
            if ptr[s] >= len(streams[s]):
                continue
            kind, m = streams[s][ptr[s]]
            if kind == "F":
                if s > 0 and f_done[s - 1][m] is None:
                    continue
                dep_t = 0.0 if s == 0 else (f_done[s - 1][m] + cf[s - 1])
                start = max(dev_free[s], dep_t)
                f_done[s][m] = start + bf[s]
                dev_free[s] = f_done[s][m]
            else:
                if f_done[s][m] is None:
                    continue
                if s < S - 1 and b_done[s + 1][m] is None:
                    continue
                dep_t = f_done[s][m] if s == S - 1 else b_done[s + 1][m] + cb[s]
                start = max(dev_free[s], dep_t, f_done[s][m])
                b_done[s][m] = start + bb[s]
                dev_free[s] = b_done[s][m]
            ptr[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:
            raise RuntimeError("1F1B schedule deadlocked (bug)")
    return max(dev_free)


# ---------------------------------------------------------------------------
# Profiled cost provider (CostProvider protocol, measured fidelity)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ProfiledCosts:
    """Cost provider recalibrated by measurements.

    ``compute_factor[device_name]`` scales that device's achievable
    compute rate (measured/analytic throughput ratio — e.g. from a
    kernel benchmark or a timed training step); ``bandwidth_factor``
    does the same per link-resource name (measured goodput / datasheet
    capacity).  Unlisted devices/links fall back to the ``default_*``
    factor, so a single global MFU correction is one constructor call.
    """

    compute_factor: Mapping[str, float] = dataclasses.field(default_factory=dict)
    bandwidth_factor: Mapping[str, float] = dataclasses.field(default_factory=dict)
    default_compute: float = 1.0
    default_bandwidth: float = 1.0
    name: str = "profiled"
    #: Where the factors came from (backend, jax version, measurement
    #: date, bench shapes, ...) — free-form strings, persisted by
    #: ``to_json`` so committed calibration artifacts stay diffable.
    provenance: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def calibrate(self, topo):
        from .device import Topology
        devs = [dataclasses.replace(
                    d, compute_efficiency=d.compute_efficiency
                    * self.compute_factor.get(d.name, self.default_compute))
                for d in topo.devices]
        res = [dataclasses.replace(
                   r, capacity=r.capacity
                   * self.bandwidth_factor.get(r.name, self.default_bandwidth))
               for r in topo.resources.values()]
        return Topology(devs, res, topo._p2p)

    def cost_model(self, graph, topo, workload):
        from .cost_model import CostModel
        return CostModel(graph, self.calibrate(topo), workload)

    @classmethod
    def from_measurements(
            cls,
            device_seconds: Mapping[str, Tuple[float, float]] = (),
            link_bytes_per_s: Mapping[str, Tuple[float, float]] = (),
            ) -> "ProfiledCosts":
        """Build factors from ``(analytic, measured)`` pairs.

        ``device_seconds`` maps a device name to (analytic step seconds,
        measured step seconds): a device measured 2x slower than the
        roofline gets factor 0.5.  ``link_bytes_per_s`` maps a link name
        to (datasheet capacity, measured goodput).
        """
        comp = {k: a / m for k, (a, m) in dict(device_seconds).items()
                if a > 0.0 and m > 0.0}
        bw = {k: m / a for k, (a, m) in dict(link_bytes_per_s).items()
              if a > 0.0 and m > 0.0}
        return cls(compute_factor=comp, bandwidth_factor=bw)

    # -- persistence (committed calibration artifacts) ----------------------
    def to_dict(self) -> dict:
        return {
            "schema": "dora-profiled-costs/v1",
            "name": self.name,
            "compute_factor": dict(self.compute_factor),
            "bandwidth_factor": dict(self.bandwidth_factor),
            "default_compute": self.default_compute,
            "default_bandwidth": self.default_bandwidth,
            "provenance": dict(self.provenance),
        }

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        """Strict-JSON serialization (optionally written to ``path``):
        factors + provenance, round-tripped exactly by :meth:`from_json`
        so calibration artifacts can be committed and diffed."""
        import json
        text = json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          allow_nan=False)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        return text

    @classmethod
    def from_dict(cls, doc: Mapping) -> "ProfiledCosts":
        schema = doc.get("schema", "dora-profiled-costs/v1")
        if not str(schema).startswith("dora-profiled-costs/"):
            raise ValueError(f"not a ProfiledCosts artifact: {schema!r}")
        return cls(
            compute_factor={str(k): float(v) for k, v
                            in doc.get("compute_factor", {}).items()},
            bandwidth_factor={str(k): float(v) for k, v
                              in doc.get("bandwidth_factor", {}).items()},
            default_compute=float(doc.get("default_compute", 1.0)),
            default_bandwidth=float(doc.get("default_bandwidth", 1.0)),
            name=str(doc.get("name", "profiled")),
            provenance={str(k): str(v) for k, v
                        in doc.get("provenance", {}).items()})

    @classmethod
    def from_json(cls, path_or_text: str) -> "ProfiledCosts":
        """Load from a JSON file path (or a raw JSON string)."""
        import json
        import os
        if os.path.exists(path_or_text):
            with open(path_or_text, encoding="utf-8") as f:
                doc = json.load(f)
        else:
            doc = json.loads(path_or_text)
        return cls.from_dict(doc)


# ---------------------------------------------------------------------------
# Paper Appendix Algorithm 2 — literal transcription.
# ``bf``/``bb`` are per-step forward/backward busy times; ``d`` is the
# stage depth the estimate is computed for.
# ---------------------------------------------------------------------------
def alg2_start_phase(bf: Sequence[float], bb: Sequence[float], d: int) -> float:
    """StartPhaseTimeEst(P, BList, d) — Algorithm 2 lines 1-13."""
    S = 2 * len(bf) - 1
    criti = 0.0
    for p in range(d, S + 1):
        cur = 0.0
        for i in range(0, min(p, len(bf) - 1) + 1):
            cur += bf[i]
        cur += (S - p) * max(bf[i] for i in range(0, min(p, len(bf) - 1) + 1))
        for i in range(min(p, len(bb) - 1), d, -1):
            cur += bb[i]
        criti = max(criti, cur)
    return criti


def alg2_end_phase(bf: Sequence[float], bb: Sequence[float], d: int) -> List[float]:
    """EndPhaseTimeEst(P, BList, d) — Algorithm 2 lines 15-30."""
    S = 2 * len(bf) - 1
    out: List[float] = []
    for s in range(0, S):
        criti = 0.0
        for p in range(max(s, d), S + 1):
            cur = 0.0
            for i in range(0, min(p, len(bb) - 1) + 1):
                cur += bb[i]
            cur += (S - p) * max(bb[i] for i in range(0, min(p, len(bb) - 1) + 1))
            for i in range(min(p, len(bf) - 1), d, -1):
                cur += bf[i]
            criti = max(criti, cur)
        out.append(criti)
    return out
