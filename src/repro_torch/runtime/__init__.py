"""Execution of a Dora plan: the pipeline executors (``pipeline``: in one
process, or one process a stage), the start of those processes (``ranks``)
and the heartbeat coordinator that the chaos engine detects failures with
(``heartbeat``, a copy of the JAX package's)."""
from .heartbeat import Coordinator, DeviceStatus

__all__ = ["Coordinator", "DeviceStatus"]
