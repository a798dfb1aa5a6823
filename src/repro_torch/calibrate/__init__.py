"""repro_torch.calibrate -- sim-to-real calibration and fidelity on the
card (PyTorch counterpart of ``repro.calibrate``).

Microbenchmarks the real compute path (the hand-written kernels, the
train and decode steps, the pipeline stage block) on the measured device,
converts the measurements into a committed
:class:`~repro_torch.core.profiler.ProfiledCosts` artifact, and closes the
loop by executing planned pipelines for real and comparing measured wall
time against the planner's predictions
(``calibration/h100_fidelity.json``).

:mod:`timing` loads eagerly; :mod:`microbench`, :mod:`host` and
:mod:`fidelity` load on first attribute access. Run the whole loop with
``python -m repro_torch.calibrate`` (on the card by default; ``--device
cpu`` measures the CPU).
"""
from __future__ import annotations

from .timing import DEFAULT_CACHE, Fleet, MeasurementCache, backend_key, block, time_callable

_LAZY = {
    "measure_host": "microbench",
    "matmul_peak_flops": "microbench",
    "memory_bandwidth": "microbench",
    "kernel_rates": "microbench",
    "step_seconds": "microbench",
    "transfer_goodput": "microbench",
    "contended_mlp_rate": "microbench",
    "host_device": "host",
    "host_topology": "host",
    "host_costs": "host",
    "calibrate_host": "host",
    "FidelityCase": "fidelity",
    "CASES": "fidelity",
    "QUICK_CASES": "fidelity",
    "run_case": "fidelity",
    "run_fidelity": "fidelity",
    "write_bench": "fidelity",
    "check_regression": "fidelity",
    "BENCH_PATH": "fidelity",
}

__all__ = ["DEFAULT_CACHE", "Fleet", "MeasurementCache", "backend_key", "block",
           "time_callable", *sorted(_LAZY)]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.calibrate' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
