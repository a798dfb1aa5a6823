# A copy of src/repro/sim/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's traces must match the reference's request for request.
"""Edge-deployment simulator.

Validates the paper's claims without edge hardware: the registered
deployment scenarios (``repro_torch.scenarios`` — Table-3 settings and
beyond), the discrete-event engine (``core.engine``), and the
contended-execution runner.  The baseline planners moved to the
strategy registry (``repro_torch.strategies``); their ``*_plan`` functions
stay re-exported here for back compatibility (the deeper
``repro_torch.sim.baselines`` shim is deprecated and warns).
"""
from ..strategies.baselines import (BaselineError, alpa_plan, asteroid_plan,
                                    brute_force_optimal, edgeshard_plan,
                                    metis_plan)
from .runner import (COMPARISON_PLANNERS, ExecResult, compare_planners,
                     dora_plan, execute_plan, run_strategy, scenario_case,
                     setting_and_graph, workload_for)
from ..core.events import poisson_arrivals
from .fleet import FleetAction, FleetTrace, simulate_fleet
from .serving import (AdapterAction, RequestLog, RequestRecord, ServingLoad,
                      ServingTrace, simulate_requests)

__all__ = [
    "BaselineError", "alpa_plan", "asteroid_plan", "brute_force_optimal",
    "edgeshard_plan", "metis_plan", "COMPARISON_PLANNERS", "ExecResult",
    "compare_planners", "dora_plan", "execute_plan", "run_strategy",
    "scenario_case", "setting_and_graph", "workload_for",
    "AdapterAction", "RequestLog", "RequestRecord", "ServingLoad",
    "ServingTrace", "poisson_arrivals", "simulate_requests",
    "FleetAction", "FleetTrace", "simulate_fleet",
]
