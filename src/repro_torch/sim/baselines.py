# A copy of src/repro/sim/baselines.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""DEPRECATED back-compat shim — the baseline planners live in
:mod:`repro_torch.strategies.baselines`, registered in the planner-strategy
registry (``repro_torch.strategies.get_strategy``).

Importing names from this module works but raises a
``DeprecationWarning``; new code should either resolve planners through
the registry or import the ``*_plan`` functions from
``repro_torch.strategies.baselines`` directly.  The re-exports on
``repro_torch.sim`` itself (``from repro_torch.sim import alpa_plan``) remain
warning-free for now.
"""
from __future__ import annotations

import warnings

__all__ = [
    "LATENCY_ONLY", "BaselineError", "alpa_plan", "asteroid_plan",
    "brute_force_optimal", "edgeshard_plan", "metis_plan",
    "plan_memory_ok", "reprice_stage",
]


def __getattr__(name: str):
    if name in __all__:
        warnings.warn(
            "repro_torch.sim.baselines is deprecated; import "
            f"{name!r} from repro_torch.strategies.baselines (or resolve the "
            "planner via repro_torch.strategies.get_strategy)",
            DeprecationWarning, stacklevel=2)
        from ..strategies import baselines as _baselines
        return getattr(_baselines, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
