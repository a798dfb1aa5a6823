# A copy of src/repro/control/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's reactions must match the reference's action for action.
"""``repro_torch.control`` — the real-time control plane (§4.3 unified).

One place reacts to runtime dynamics: :class:`ControlPlane` (single
session), :class:`FleetControlPlane` (multi-tenant) and
:class:`StaticPlane` (non-adaptive baselines).  ``ServeSession``,
``FleetSession``, the fallback ladder and the chaos engine are thin
adapters over these.  :class:`ControlConfig` switches the within-plan
mechanisms (priority preemption, battery SoC, streamed migration);
everything defaults off, and the off-path is bit-identical to the
pre-control-plane runtime.
"""
from .battery import SOC_CHECK_LABEL, BatteryTracker
from .plane import (ControlConfig, ControlPlane, FleetControlPlane,
                    StaticPlane, _remap_plan, react_once)

__all__ = [
    "BatteryTracker", "ControlConfig", "ControlPlane", "FleetControlPlane",
    "SOC_CHECK_LABEL", "StaticPlane", "react_once", "_remap_plan",
]
