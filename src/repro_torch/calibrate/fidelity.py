"""Plan -> execute -> compare: how well do planner latencies match the
card? (PyTorch counterpart of ``repro.calibrate.fidelity``.)

For each fidelity case (a fleet twin of a catalog scenario, with the
scenario's real workload geometry) the loop:

1. builds a proxy model -- a chain of silu-gated MLP blocks whose
   planning-graph costs (``6*d*f`` FLOPs/token forward, 3x for the
   remat'd backward, f32 parameter bytes) exactly describe the executable
   ``gated_mlp_layer`` -- and a fleet whose per-device memory forces a
   multi-stage plan;
2. runs the port's planner (``DoraPlanner``) over it and takes the best
   single-device-per-stage pipeline layout (falling back to an even chain
   split when every candidate is data-parallel);
3. prices that same layout under both cost providers -- the analytic
   datasheet roofline and the measured :class:`ProfiledCosts` from
   :mod:`repro_torch.calibrate.host` -- giving two predicted iteration
   latencies;
4. executes the layout through the port's
   :class:`~repro_torch.runtime.pipeline.DoraPipelineExecutor` on the
   logical fleet (``forward`` for serving; ``loss`` and its backward for
   training) and times the iteration in wall seconds;
5. reports both relative errors into ``calibration/h100_fidelity.json``.

On one card the fleet's N logical devices all run on it, as the
executor's stages do: so the uncalibrated datasheet prediction (matmul
peak x default MFU, every device at full rate) is structurally
optimistic, while the contended-rate measurement prices what a stage
really gets.

CLI::

    python -m repro_torch.calibrate                 # full bench + rewrite the JSON
    python -m repro_torch.calibrate --check
        # re-run the quick subset; fail if the calibrated mean relative
        # error exceeds the committed quick numbers by
        # >BENCH_REGRESSION_FACTOR (default 1.5x)
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.cost_model import CostRef, Workload, resolve_costs
from ..core.device import Topology
from ..core.partitioner import PartitionerConfig
from ..core.planner import DoraPlanner
from ..core.planning_graph import LayerNode, ModelGraph
from ..core.plans import ParallelismPlan, Stage
from ..core.qoe import QoESpec
from .host import host_costs, host_topology
from .microbench import (contended_mlp_rate, gated_mlp_layer, init_gated_mlp,
                         matmul_peak_flops, memory_bandwidth,
                         transfer_goodput)
from .timing import Fleet, MeasurementCache, backend_key, full_f32, time_callable

BENCH_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "calibration",
                 "h100_fidelity.json"))
#: Where a CPU run's record goes (git-ignored): never the card's file.
CPU_BENCH_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "calibration",
                 "cpu_fidelity.json"))
SCHEMA = "dora-bench-fidelity/v1"

#: Rank plans purely by latency (objective = lambda * latency with lambda
#: huge): fidelity measures latency prediction, not the QoE trade-off.
LATENCY_QOE = QoESpec(t_qoe=0.0, lam=1e15)

#: Best-of-N of the two timings a case compares, the contended stage block
#: and the executed pipeline (the JAX package takes 2-4). A case's iteration
#: takes 2-90 ms on the card, where fresh processes' readings spread less at
#: 10 than at 3 (``tools/fidelity_spread.py``; PERF.md section 6).
CASE_REPEATS = 10

@dataclasses.dataclass(frozen=True)
class FidelityCase:
    """A fleet twin of one catalog scenario.

    The *workload* (train vs serve, global batch, microbatch geometry)
    comes from the named catalog scenario; the proxy model and fleet
    size are scaled so the case plans and executes in seconds while still
    forcing a genuine multi-stage pipeline.
    """

    scenario: str          # catalog scenario this case mirrors
    n_devices: int         # fleet size (<= the logical fleet)
    n_layers: int          # proxy chain depth
    d_model: int
    d_ff: int
    tokens: int            # tokens per workload sample

    def rows(self, wl: Workload) -> int:
        """Microbatch rows the executor sees (samples x tokens)."""
        return wl.microbatch_size * self.tokens


#: The fidelity suite -- the JAX package's cases: 3 serve, 1 train.
CASES: Tuple[FidelityCase, ...] = (
    FidelityCase("traffic_monitor", 4, 16, 512, 2048, 16),
    FidelityCase("hospital_ward", 4, 12, 512, 2048, 16),
    FidelityCase("vehicle_platoon", 4, 8, 512, 2048, 16),
    FidelityCase("smart_home_2", 4, 12, 384, 1536, 4),
)

#: The CI subset: smaller proxies, 2-device fleets, still serve + train.
QUICK_CASES: Tuple[FidelityCase, ...] = (
    FidelityCase("traffic_monitor", 2, 8, 256, 1024, 8),
    FidelityCase("vehicle_platoon", 2, 6, 256, 1024, 8),
    FidelityCase("smart_home_2", 2, 6, 256, 1024, 4),
)


# -- proxy model ------------------------------------------------------------------
def proxy_graph(case: FidelityCase) -> ModelGraph:
    """Chain of LayerNodes that *exactly* prices ``gated_mlp_layer``:
    3 matmuls -> ``6*d*f`` FLOPs per token forward, 3x that backward
    (grad-x + grad-w + remat recompute -- the executor remats every
    stage), f32 parameters, f32 boundary activations."""
    d, f, t = case.d_model, case.d_ff, case.tokens
    nodes = [LayerNode(name=f"mlp{i}",
                       flops_fwd=6.0 * d * f * t,
                       param_bytes=3.0 * d * f * 4.0,
                       act_bytes=4.0 * d * t,
                       flops_bwd=18.0 * d * f * t)
             for i in range(case.n_layers)]
    return ModelGraph.chain(nodes)


def fleet_memory(graph: ModelGraph, wl: Workload, n: int) -> float:
    """Per-device memory that forces a multi-stage plan: ~1.45x the
    even n-way share of the model (+ optimizer) state -- one device can
    never hold the whole model, so the planner must pipeline."""
    mult = wl.optimizer_mult if wl.training else 1.0
    return 1.45 * graph.total_params * mult / n


# -- layout selection -------------------------------------------------------------
Layout = List[Tuple[List[int], int]]        # [(node_ids, device), ...] in order


def plan_layout(graph: ModelGraph, topo: Topology, wl: Workload
                ) -> Tuple[Layout, str]:
    """Run the port's planner; return the best executable pipeline layout.

    The executor runs one device per stage, so we take the best-ranked
    candidate whose stages are all single-device (dp=1) with >=2 stages.
    If the whole pool is data-parallel (it never is once memory forces
    pipelining), fall back to an even chain split -- and say so in the
    record, because then the *planner's* choice was not what executed.
    """
    cfg = PartitionerConfig(schedule="gpipe", delta=0.0, top_k=8)
    planner = DoraPlanner(graph, topo, LATENCY_QOE,
                          partitioner_config=cfg)
    result = planner.plan(wl)
    for plan in result.candidates:
        if plan.n_stages >= 2 and all(len(s.devices) == 1
                                      for s in plan.stages):
            return ([(list(s.node_ids), s.devices[0])
                     for s in plan.stages], "planner")
    n = topo.n
    L = len(graph.nodes)
    bounds = [round(i * L / n) for i in range(n + 1)]
    layout = [(list(range(bounds[i], bounds[i + 1])), i)
              for i in range(n) if bounds[i + 1] > bounds[i]]
    return layout, "even-chain-fallback"


def evaluate_layout(layout: Layout, graph: ModelGraph, topo: Topology,
                    wl: Workload, costs: CostRef = None,
                    schedule: str = "gpipe") -> ParallelismPlan:
    """Price a fixed stage layout under any cost provider.

    Keeping the layout fixed while swapping the provider is what makes
    the calibrated-vs-uncalibrated comparison clean: same stages, same
    devices, only the assumed rates differ."""
    cm = resolve_costs(costs).cost_model(graph, topo, wl)
    stages = []
    for i, (ids, dev) in enumerate(layout):
        nxt = [layout[i + 1][1]] if i + 1 < len(layout) else None
        stages.append(cm.make_stage(ids, [dev], nxt))
    return cm.evaluate(stages, LATENCY_QOE, schedule=schedule)


# -- execution --------------------------------------------------------------------
def execute_layout(case: FidelityCase, layout: Layout, wl: Workload, *,
                   warmup: int = 1, repeats: int = 3,
                   fleet: Optional[Fleet] = None) -> float:
    """Run the layout through the port's pipeline executor on the logical
    ``fleet`` (``Fleet()`` by default); wall seconds of one iteration (all
    microbatches through the pipeline; training adds the loss's backward
    through the remat'd stages)."""
    from ..runtime.pipeline import DoraPipelineExecutor

    fleet = fleet if fleet is not None else Fleet()
    need = max(dev for _, dev in layout) + 1
    if fleet.n_devices < need:
        raise RuntimeError(
            f"fidelity needs {need} logical devices but the fleet has "
            f"{fleet.n_devices}; pass --devices {need} to "
            f"`python -m repro_torch.calibrate`")
    devices = fleet.devices()
    stages = [Stage(node_ids=list(ids), devices=[dev],
                    microbatch_split={dev: 1.0})
              for ids, dev in layout]
    plan = ParallelismPlan(stages=stages, microbatch_size=wl.microbatch_size,
                           n_microbatches=wl.n_microbatches,
                           training=wl.training)
    ex = DoraPipelineExecutor(plan, case.n_layers, gated_mlp_layer,
                              devices=[devices[dev] for _, dev in layout])
    dev0 = fleet.torch_device()
    packed = ex.pack_params(init_gated_mlp(case.n_layers, case.d_model, case.d_ff,
                                           torch.Generator(device=dev0).manual_seed(0)))
    gen = torch.Generator(device=dev0).manual_seed(1)
    x = torch.randn((wl.n_microbatches, case.rows(wl), case.d_model), generator=gen,
                    device=dev0)
    if wl.training:
        leaves = [v.requires_grad_(True) for v in packed.values()]

        def run():
            loss = ex.loss(packed, x, lambda out: torch.mean(out * out))
            return torch.autograd.grad(loss, leaves)
    else:
        def run():
            with torch.no_grad():
                return ex.forward(packed, x)
    with full_f32():
        return time_callable(run, warmup=warmup, repeats=repeats)


# -- per-case fidelity ------------------------------------------------------------
def run_case(case: FidelityCase, cache: Optional[MeasurementCache] = None, *,
             quick: bool = False) -> Dict[str, object]:
    """Measure one fidelity case end to end (see module docstring)."""
    from ..runtime.pipeline import PipelineSpec
    from ..scenarios import get_scenario

    cache = cache if cache is not None else MeasurementCache()
    fleet = cache.fleet
    wl = get_scenario(case.scenario).workload
    graph = proxy_graph(case)
    rep = 2 if quick else 4
    dim = 512 if quick else 1024
    measure = {
        "matmul_peak_flops": cache.get_or_measure(
            "matmul_peak", f"d{dim}",
            lambda: matmul_peak_flops(dim, repeats=rep, device=fleet.device)),
        "memory_bw": cache.get_or_measure(
            "memory_bw", "64MiB",
            lambda: memory_bandwidth(repeats=rep, device=fleet.device)),
    }
    if fleet.n_devices > 1:
        measure["transfer_large_bps"] = cache.get_or_measure(
            "transfer", "16MiB", lambda: transfer_goodput(1 << 24,
                                                          repeats=rep, fleet=fleet))
        measure["transfer_small_bps"] = cache.get_or_measure(
            "transfer", "64KiB", lambda: transfer_goodput(1 << 16,
                                                          repeats=rep, fleet=fleet))
    topo = host_topology(measure, case.n_devices,
                         memory=fleet_memory(graph, wl, case.n_devices))
    layout, source = plan_layout(graph, topo, wl)
    S = len(layout)
    # pad = the most layers a stage computes per tick: measure the
    # contended rate on a block of that many layers
    pad = PipelineSpec.from_plan(
        ParallelismPlan(stages=[Stage(node_ids=ids, devices=[d],
                                      microbatch_split={d: 1.0})
                                for ids, d in layout],
                        microbatch_size=wl.microbatch_size,
                        n_microbatches=wl.n_microbatches),
        case.n_layers).pad
    rows = case.rows(wl)
    mode = "train" if wl.training else "serve"
    contended = cache.get_or_measure(
        "contended_mlp",
        f"{mode}/n{S}/r{rows}/d{case.d_model}x{case.d_ff}/l{pad}",
        lambda: contended_mlp_rate(S, rows=rows, d_model=case.d_model,
                                   d_ff=case.d_ff, layers=pad,
                                   training=wl.training,
                                   repeats=CASE_REPEATS, fleet=fleet))
    costs = host_costs(measure, case.n_devices, contended=contended,
                       name=f"profiled-host/{case.scenario}", fleet=fleet)
    uncal = evaluate_layout(layout, graph, topo, wl)
    cal = evaluate_layout(layout, graph, topo, wl, costs=costs)
    measured = execute_layout(case, layout, wl, repeats=CASE_REPEATS, fleet=fleet)
    rec: Dict[str, object] = {
        "scenario": case.scenario,
        "mode": mode,
        "layout": source,
        "n_stages": S,
        "layers": case.n_layers,
        "d_model": case.d_model,
        "d_ff": case.d_ff,
        "microbatches": wl.n_microbatches,
        "measured_s": measured,
        "uncalibrated": {"predicted_s": uncal.latency,
                         "rel_err": abs(uncal.latency - measured) / measured},
        "calibrated": {"predicted_s": cal.latency,
                       "rel_err": abs(cal.latency - measured) / measured},
        "compute_factor": next(iter(costs.compute_factor.values())),
    }
    return rec


def run_fidelity(cases: Optional[Sequence[FidelityCase]] = None, *,
                 quick: bool = False,
                 cache: Optional[MeasurementCache] = None
                 ) -> Dict[str, object]:
    """The ``current`` section of ``calibration/h100_fidelity.json``."""
    cases = list(cases if cases is not None
                 else (QUICK_CASES if quick else CASES))
    cache = cache if cache is not None else MeasurementCache()
    recs = {c.scenario: run_case(c, cache, quick=quick) for c in cases}
    mean_unc = sum(r["uncalibrated"]["rel_err"]
                   for r in recs.values()) / len(recs)
    mean_cal = sum(r["calibrated"]["rel_err"]
                   for r in recs.values()) / len(recs)
    return {
        "commit": _commit(),
        "backend": backend_key(cache.fleet),
        "cases": recs,
        "mean_rel_err_uncalibrated": mean_unc,
        "mean_rel_err_calibrated": mean_cal,
        "calibration_gain": (mean_unc / mean_cal if mean_cal > 0.0
                             else float("inf")),
    }


# -- the committed artifact -------------------------------------------------------
def _commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(BENCH_PATH)).stdout.strip()
    except OSError:
        return "unknown"


def write_bench(current: Dict[str, object],
                path: str = BENCH_PATH) -> Dict[str, object]:
    """Merge ``current`` with the committed doc and write ``path``.

    The ``baseline`` section is sticky (seeded from the first full run,
    never overwritten) so the trajectory of fidelity across PRs stays
    visible."""
    doc: Dict[str, object] = {"schema": SCHEMA}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    doc["schema"] = SCHEMA
    doc.setdefault("method",
                   "plan a proxy pipeline over a logical fleet with the port's "
                   "DoraPlanner, price the chosen layout under analytic vs measured "
                   "(ProfiledCosts) rates, execute it for real through "
                   "repro_torch.runtime.pipeline with every stage on the measured "
                   "device, report |predicted-measured|/measured per "
                   "catalog-scenario twin")
    doc.setdefault("baseline", current)
    doc["current"] = current
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def write_quick(quick_section: Dict[str, object],
                path: str = BENCH_PATH) -> None:
    """Rewrite only the ``quick`` section of the committed doc."""
    doc: Dict[str, object] = {"schema": SCHEMA}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    doc["quick"] = quick_section
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def refresh_quick(path: str = BENCH_PATH,
                  cache: Optional[MeasurementCache] = None) -> None:
    """Re-measure and rewrite only the ``quick`` section."""
    write_quick(run_fidelity(quick=True, cache=cache), path)


#: Absolute error the gate always tolerates: with a well-calibrated
#: committed reference (errors of a few %), a pure ratio gate would sit
#: inside run-to-run wall-clock noise.  Genuine fidelity regressions (a
#: broken calibration path reverts predictions toward the uncalibrated
#: error) clear this floor by a wide margin.
GATE_FLOOR = 0.25


def check_regression(path: str = BENCH_PATH, fleet: Optional[Fleet] = None) -> int:
    """Regression gate: quick-subset calibrated fidelity vs. committed
    numbers.

    Re-runs the quick cases on ``fleet`` (``Fleet()`` by default;
    measurement cache off -- the gate must measure its own hardware) and
    rewrites the artifact's ``quick`` section.  Fails (returns 1) when either

    * calibration stops helping -- calibrated mean relative error is no
      longer below uncalibrated (the machine-independent invariant) --
    * or the calibrated error exceeds the committed quick value by more
      than ``BENCH_REGRESSION_FACTOR`` (default 1.5x) *and* the
      absolute :data:`GATE_FLOOR`.
    """
    factor = float(os.environ.get("BENCH_REGRESSION_FACTOR", "1.5"))
    committed: Dict[str, object] = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            committed = json.load(f)
    ref = committed.get("quick")
    cur = run_fidelity(quick=True, cache=MeasurementCache(path=None, fleet=fleet))
    write_quick(cur, path)
    cal = cur["mean_rel_err_calibrated"]
    unc = cur["mean_rel_err_uncalibrated"]
    print(f"quick calibrated mean rel err: {cal:.3f} "
          f"(uncalibrated {unc:.3f})")
    if cal >= unc:
        print(f"FAIL: calibration no longer helps "
              f"(calibrated {cal:.3f} >= uncalibrated {unc:.3f})")
        return 1
    if ref is None:
        print("no committed quick section; recorded this run as the seed")
        return 0
    gate = max(ref["mean_rel_err_calibrated"] * factor, GATE_FLOOR)
    if cal > gate:
        print(f"FAIL: calibrated fidelity regressed to {cal:.3f} "
              f"(committed {ref['mean_rel_err_calibrated']:.3f}, "
              f"gate max({factor:.2f}x, floor {GATE_FLOOR}) -> {gate:.3f})")
        return 1
    print(f"fidelity regression gate: OK ({cal:.3f} <= {gate:.3f})")
    return 0
