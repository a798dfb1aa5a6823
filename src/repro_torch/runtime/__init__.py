"""Execution of a Dora plan: the pipeline executors (``pipeline``: in one
process, or one process a stage), the start of those processes and their
regrouping (``ranks``), the heartbeat coordinator that the chaos engine
detects failures with (``heartbeat``, a copy of the JAX package's) and the
elastic controller that shrinks a training mesh onto the surviving ranks
(``elastic``)."""
from .elastic import ElasticController, ElasticState
from .heartbeat import Coordinator, DeviceStatus

__all__ = ["Coordinator", "DeviceStatus", "ElasticController", "ElasticState"]
