# A copy of src/repro/sim/kernel.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""Alias for the shared serving kernel.

The kernel lives in :mod:`repro_torch.core.events` so the scenario registry
and the plan-level engine can use it without importing the simulator
package; ``repro_torch.sim.kernel`` re-exports it under the name the
simulators advertise.
"""
from ..core.events import *  # noqa: F401,F403
from ..core.events import __all__  # noqa: F401
