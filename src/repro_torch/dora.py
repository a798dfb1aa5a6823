"""``repro_torch.dora``: the slice of the JAX package's facade
(``repro.dora``) that the serve launcher uses.

    from repro_torch import dora

    session = dora.serve("smart_home_2", graph=..., qoe=..., workload=...)
    session.report.result.best          # the plan (a ParallelismPlan)
    session.adapter.on_dynamics(session.current, event)

``planner_for`` and ``serve`` keep the semantics of their JAX
counterparts with ``control=None``: keyword overrides swap any
ingredient, the rest comes from the setting. The settings are the paper's
four Table 3 deployments, each resolved by ``make_setting`` with the
model, workload and QoE that the JAX package's scenario catalogue gives
it; the rest of that catalogue is not ported yet and raises. Planning is
analytic host code, as in the JAX package: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .core.adapter import AdapterConfig, RuntimeAdapter
from .core.cost_model import (PAPER_SERVE_WORKLOAD, PAPER_TRAIN_WORKLOAD, CostProvider,
                              Workload)
from .core.device import Topology, make_setting
from .core.graph_builders import paper_model
from .core.partitioner import PartitionerConfig
from .core.planner import DoraPlanner, PlanningResult
from .core.planning_graph import ModelGraph
from .core.plans import ParallelismPlan
from .core.qoe import QoESpec
from .core.scheduler import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class Setting:
    """A Table 3 deployment's defaults (``repro.scenarios.catalog``)."""
    model: str
    workload: Workload
    qoe: QoESpec


# the catalogue's training sequence length (``Scenario.seq_len``)
SEQ_LEN = 512

TABLE3: Dict[str, Setting] = {
    "smart_home_1": Setting("qwen3-0.6b", PAPER_TRAIN_WORKLOAD, QoESpec(t_qoe=6.0, lam=50.0)),
    "smart_home_2": Setting("qwen3-0.6b", PAPER_TRAIN_WORKLOAD, QoESpec(t_qoe=8.0, lam=50.0)),
    "traffic_monitor": Setting("qwen3-0.6b", PAPER_SERVE_WORKLOAD,
                               QoESpec(t_qoe=0.2, lam=100.0)),
    "edge_cluster": Setting("qwen3-1.7b", PAPER_TRAIN_WORKLOAD, QoESpec(t_qoe=2.0, lam=50.0)),
}


def get_setting(name: str) -> Setting:
    if name not in TABLE3:
        raise NotImplementedError(
            f"setting {name!r}: the port plans the four Table 3 settings "
            f"({', '.join(sorted(TABLE3))}); the rest of the scenario registry is not "
            f"ported yet (ROADMAP: Queue 1 'Scenarios')")
    return TABLE3[name]


@dataclasses.dataclass
class PlanReport:
    """What planning one setting produced."""
    setting: str
    topology: Topology
    graph: ModelGraph
    workload: Workload
    qoe: QoESpec
    result: PlanningResult

    @property
    def best(self) -> ParallelismPlan:
        return self.result.best


@dataclasses.dataclass
class ServeSession:
    """A planned setting with the runtime adapter armed over its plans."""
    report: PlanReport
    adapter: RuntimeAdapter
    current: ParallelismPlan


def planner_for(setting: str, *,
                topology: Optional[Topology] = None,
                graph: Optional[ModelGraph] = None,
                workload: Optional[Workload] = None,
                qoe: Optional[QoESpec] = None,
                partitioner_config: Optional[PartitionerConfig] = None,
                scheduler_config: Optional[SchedulerConfig] = None,
                adapter_config: Optional[AdapterConfig] = None,
                costs: Optional[CostProvider] = None
                ) -> Tuple[DoraPlanner, Workload]:
    """(planner, workload) for ``setting`` and the overrides, not yet run."""
    st = get_setting(setting)
    topo = topology if topology is not None else make_setting(setting)
    wl = workload if workload is not None else st.workload
    q = qoe if qoe is not None else st.qoe
    if graph is None:       # serving plans per generated token: seq_len 1
        graph = paper_model(st.model, seq_len=SEQ_LEN if st.workload.training else 1)
    planner = DoraPlanner(graph, topo, q, partitioner_config=partitioner_config,
                          scheduler_config=scheduler_config,
                          adapter_config=adapter_config, costs=costs)
    return planner, wl


def serve(setting: str, **overrides) -> ServeSession:
    """Plan ``setting`` and arm the runtime adapter over its candidates.
    Raises ``RuntimeError`` when no plan meets the QoE, as the JAX
    package does."""
    planner, wl = planner_for(setting, **overrides)
    result = planner.plan(wl)
    report = PlanReport(setting=setting, topology=planner.topo, graph=planner.graph,
                        workload=wl, qoe=planner.qoe, result=result)
    return ServeSession(report=report, adapter=planner.make_adapter(result),
                        current=result.best)
