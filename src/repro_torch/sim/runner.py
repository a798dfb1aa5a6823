# A copy of src/repro/sim/runner.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""Execute plans on the real (contended) topology; planner comparisons.

Dora plans run through the Phase-2 network scheduler (chunked temporal
sharing); contention-oblivious baselines execute with fluid-shared
("fair") contention — what a real shared medium does to them (Fig. 2).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

from ..core.cost_model import Workload
from ..core.device import Topology
from ..core.graph_builders import paper_model
from ..core.planner import PlanningResult
from ..core.planning_graph import ModelGraph
from ..core.plans import ParallelismPlan
from ..core.qoe import QoESpec
from ..core.scheduler import NetworkScheduler, SchedulerConfig
from ..scenarios import PAPER_SETTINGS, get_scenario
from ..strategies import StrategyError, get_strategy

SETTINGS = PAPER_SETTINGS
PAPER_MODELS = ("bert", "qwen3-0.6b", "qwen3-1.7b", "qwen-omni")

#: Fig. 8/9 comparison set — resolved through the strategy registry.
COMPARISON_PLANNERS = ("edgeshard", "alpa", "metis", "asteroid", "dora")


@dataclasses.dataclass
class ExecResult:
    planner: str
    latency: float = float("inf")       # seconds (iteration or batch-forward)
    energy: float = float("inf")        # joules over the run unit
    plan: Optional[ParallelismPlan] = None
    plan_seconds: float = 0.0           # planning wall time
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def failure_label(self) -> str:
        """Short table cell for a failed run: the paper's OOM finding vs
        an unexpected strategy bug."""
        if self.error is None:
            return ""
        return "OOM" if "OOM" in self.error else "ERR"


def workload_for(mode: str, global_batch: int = 32,
                 microbatch: int = 4) -> Workload:
    """Paper-style workloads: training iterations vs inference forwards.

    Derived from the canonical ``core.cost_model.PAPER_*_WORKLOAD``
    constants (also used by the scenario catalogue), so scenario-default
    and mode-override sweeps stay comparable. Edge tuning state is bf16
    params + grads + momentum (3× param bytes): a 6B Qwen-Omni cannot
    hold fp32 Adam m/v on phones/laptops, and §5's prototype fine-tunes
    with DDP/PiPPy-style bf16 state.
    """
    from ..core.cost_model import PAPER_SERVE_WORKLOAD, PAPER_TRAIN_WORKLOAD
    if mode == "train":
        return dataclasses.replace(PAPER_TRAIN_WORKLOAD,
                                   global_batch=global_batch,
                                   microbatch_size=microbatch)
    return dataclasses.replace(PAPER_SERVE_WORKLOAD,
                               global_batch=max(global_batch // 4, 4))


def execute_plan(plan: ParallelismPlan, topo: Topology, qoe: QoESpec,
                 scheduled: bool,
                 compute_speed: Optional[Dict[int, float]] = None,
                 bandwidth_scale: Optional[Dict[str, float]] = None
                 ) -> ParallelismPlan:
    """Run one plan on the real topology. ``scheduled=True`` applies
    Dora's Phase-2 chunked schedule; ``False`` is fluid-share contention."""
    sched = NetworkScheduler(topo, qoe)
    if scheduled:
        return sched.refine(plan, compute_speed=compute_speed,
                            bandwidth_scale=bandwidth_scale)
    return sched.evaluate_fair(plan, compute_speed=compute_speed,
                               bandwidth_scale=bandwidth_scale)


def dora_plan(graph: ModelGraph, topo: Topology, qoe: QoESpec, wl: Workload,
              top_k: int = 10,
              scheduler_config: Optional[SchedulerConfig] = None
              ) -> PlanningResult:
    strat = get_strategy("dora", top_k=top_k, sweep_microbatch=True,
                         scheduler_config=scheduler_config)
    return strat.plan(graph, topo, qoe, wl)


def run_strategy(name: str, graph: ModelGraph, topo: Topology, wl: Workload,
                 qoe: QoESpec, **params) -> ExecResult:
    """Resolve one registered strategy and wrap its outcome (errors are a
    result, not an exception — a failing baseline is the finding)."""
    strat = get_strategy(name, **params)
    t0 = time.perf_counter()
    try:
        res = strat.plan(graph, topo, qoe, wl)
    except StrategyError as e:         # expected planner failure (e.g. OOM)
        return ExecResult(planner=name, error=str(e),
                          plan_seconds=time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — keep comparing, but mark as a bug
        return ExecResult(planner=name, error=f"{type(e).__name__}: {e}",
                          plan_seconds=time.perf_counter() - t0)
    return ExecResult(planner=name, latency=res.best.latency,
                      energy=res.best.energy, plan=res.best,
                      plan_seconds=res.total_s)


def compare_planners(graph: ModelGraph, topo: Topology, wl: Workload,
                     qoe: Optional[QoESpec] = None, top_k: int = 10,
                     planners: Sequence[str] = COMPARISON_PLANNERS
                     ) -> Dict[str, ExecResult]:
    """Fig. 8/9 harness: every planner on one (model, setting, workload).

    All planners resolve through the strategy registry; ``dora`` gets the
    richer ``top_k``/microbatch-sweep search the benchmarks use."""
    qoe = qoe or QoESpec(t_qoe=0.0, lam=1e15)   # latency-optimized comparison
    out: Dict[str, ExecResult] = {}
    for name in planners:
        params = (dict(top_k=top_k, sweep_microbatch=True)
                  if name == "dora" else {})
        out[name] = run_strategy(name, graph, topo, wl, qoe, **params)
    return out


def best_baseline(results: Dict[str, ExecResult]) -> Tuple[str, ExecResult]:
    ok = {k: v for k, v in results.items() if k != "dora" and v.ok}
    if not ok:
        raise RuntimeError("no baseline produced a valid plan")
    name = min(ok, key=lambda k: ok[k].latency)
    return name, ok[name]


def _norm_mode(mode: str) -> str:
    """Benchmarks say "infer"; Scenario.mode says "serve" — same thing."""
    if mode in ("infer", "serve"):
        return "serve"
    if mode == "train":
        return "train"
    raise ValueError(f"unknown mode {mode!r}: expected 'train', 'serve' "
                     f"or 'infer'")


def scenario_case(setting: str, model: Optional[str] = None,
                  mode: Optional[str] = None, seq_len: Optional[int] = None
                  ) -> Tuple[Topology, ModelGraph, Workload]:
    """(topology, graph, workload) for one registered scenario.

    The scenario supplies all three by default; ``model``/``mode``/
    ``seq_len`` override its model, train-vs-serve direction or
    sequence length for paper-style sweeps (the workload geometry
    then comes from ``workload_for``).
    """
    sc = get_scenario(setting)
    mode = _norm_mode(mode) if mode is not None else sc.mode
    topo, graph = setting_and_graph(setting, model, mode, seq_len)
    wl = sc.workload if mode == sc.mode else (
        workload_for("train" if mode == "train" else "infer"))
    return topo, graph, wl


def setting_and_graph(setting: str, model: Optional[str] = None,
                      mode: str = "train", seq_len: Optional[int] = None
                      ) -> Tuple[Topology, ModelGraph]:
    """Resolve a scenario name to (topology, planning graph).

    ``setting`` is any name in the ``repro_torch.scenarios`` registry (the
    paper's Table-3 settings included). ``model`` overrides the
    scenario's own model with a paper-model name, which is how the
    Fig. 8/9 harnesses sweep models × settings over one fleet.
    ``seq_len`` defaults to the scenario's own sequence length
    (paper-model overrides keep the historical 512).
    """
    sc = get_scenario(setting)
    mode = _norm_mode(mode)
    topo = sc.build_topology()
    if seq_len is not None:
        eff_seq = seq_len                            # explicit always wins
    elif mode != "train":
        eff_seq = 1                                  # per-token serving
    else:
        eff_seq = sc.seq_len if model is None else 512
    if model is None:
        graph = sc.build_graph(seq_len=eff_seq)
    else:
        graph = paper_model(model, seq_len=eff_seq)
    return topo, graph
