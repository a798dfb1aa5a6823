"""Dora core: QoE-aware hybrid parallelism planning, the port's copy.

Each module here is a verbatim copy of its counterpart under
``src/repro/core/`` (the port imports nothing of the JAX package, not even
its jax-free planner). ``tests/test_torch_planner.py`` holds the copies to
the originals and the plans to the JAX package's. The facade is
``repro_torch.dora``:

    graph   = repro_torch.models.registry.planning_graph(cfg, seq_len=4096)
    session = repro_torch.dora.serve("smart_home_2", graph=graph, ...)
    plan    = session.report.result.best
"""
from .adapter import AdapterConfig, DynamicsEvent, RuntimeAdapter, pareto_filter
from .cost_model import CostModel, Workload
from .device import CATALOG, DeviceProfile, LinkResource, Topology, make_setting
from .engine import EventEngine, ScheduleResult, Task, chunk_comm_tasks
from .graph_builders import GraphSpec, build_lm_graph, build_multimodal_graph, paper_model
from .partitioner import ModelPartitioner, PartitionerConfig
from .planner import DoraPlanner, PlanningResult
from .planning_graph import LayerNode, ModelGraph
from .plans import ParallelismPlan, Stage
from .qoe import QoESpec
from .scheduler import NetworkScheduler, SchedulerConfig

__all__ = [
    "AdapterConfig", "DynamicsEvent", "RuntimeAdapter", "pareto_filter",
    "CostModel", "Workload", "CATALOG", "DeviceProfile", "LinkResource",
    "Topology", "make_setting", "EventEngine", "ScheduleResult", "Task",
    "chunk_comm_tasks", "GraphSpec", "build_lm_graph", "build_multimodal_graph",
    "paper_model", "ModelPartitioner", "PartitionerConfig", "DoraPlanner",
    "PlanningResult", "LayerNode", "ModelGraph", "ParallelismPlan", "Stage",
    "QoESpec", "NetworkScheduler", "SchedulerConfig",
]
