# A copy of src/repro/strategies/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""``repro_torch.strategies`` — pluggable planner strategies, one registry.

Every hybrid-parallelism planner in this repo — Dora itself, the paper's
§6.1 baselines, and split heuristics from related work — implements the
:class:`PlannerStrategy` protocol and registers under a name:

========================  ====================================================
``dora``                  Algorithm 1: partition → schedule → Pareto (QoE-aware)
``throughput_max``        rate-optimal planning on the real topology
``chain_split``           DistrEdge-style speed-balanced layer chaining
``memory_balanced``       chain split balanced on device memory
``pareto_split``          "Where to Split?" split-point Pareto analysis
``edgeshard``             even layer chain, memory-oblivious (EdgeShard-like)
``asteroid``              throughput-max under idealized D2D (Asteroid-like)
``alpa``                  homogeneous-cluster automation (Alpa-like)
``metis``                 balanced compute, uniform network (Metis-like)
``brute_force``           exhaustive split search, contention-priced shortlist
========================  ====================================================

Resolve with :func:`get_strategy` (constructor keywords forwarded), list
with :func:`list_strategies`, and add your own planner with::

    from repro_torch.strategies import register_strategy

    @register_strategy
    class MyStrategy:
        name = "my_planner"
        contention_aware = False
        def plan(self, graph, topology, qoe, workload, costs=None):
            ...

Cost fidelity is orthogonal: every ``plan`` accepts a ``costs=``
:class:`repro_torch.core.cost_model.CostProvider` (analytic rooflines by
default, measurement-calibrated with
:class:`repro_torch.core.profiler.ProfiledCosts`).
"""
from __future__ import annotations

from ..core.cost_model import ANALYTIC_COSTS, AnalyticCosts, CostProvider, \
    resolve_costs
from ..core.profiler import ProfiledCosts
from .base import PlannerStrategy, StrategyError, StrategyRef, as_result, \
    fair_executed, get_strategy, list_strategies, register_strategy

# Importing these modules registers the built-in strategies.
from . import baselines  # noqa: E402,F401  (registration side effects)
from . import dora_strategy  # noqa: E402,F401
from . import splits  # noqa: E402,F401

from .baselines import BaselineError  # noqa: E402
from .dora_strategy import DoraStrategy  # noqa: E402

__all__ = [
    "PlannerStrategy", "StrategyError", "StrategyRef", "BaselineError",
    "register_strategy", "get_strategy", "list_strategies",
    "as_result", "fair_executed", "DoraStrategy",
    "CostProvider", "AnalyticCosts", "ANALYTIC_COSTS", "ProfiledCosts",
    "resolve_costs",
]
