"""Execution of a Dora plan: the pipeline executor (``pipeline``) and the
heartbeat coordinator that the chaos engine detects failures with
(``heartbeat``, a copy of the JAX package's)."""
from .heartbeat import Coordinator, DeviceStatus

__all__ = ["Coordinator", "DeviceStatus"]
