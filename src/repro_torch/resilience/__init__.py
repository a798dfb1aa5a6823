# A copy of src/repro/resilience/__init__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's chaos traces must match the reference's event for event.
"""Resilience layer: unannounced faults, detection-latency-aware serving,
and a degraded-plan fallback ladder.

The serving stack historically only modeled *announced* churn
(``DynamicsEvent.leave/join`` at a known instant, clean replanning, no
request ever fails). This package makes unannounced failure a
first-class dynamic:

- :mod:`repro_torch.resilience.faults` — the fault model (``Fault``,
  ``FaultScript``), the client-side ``RetryPolicy`` and the
  ``ResilienceConfig`` knobs (heartbeat cadence, detection window).
- :mod:`repro_torch.resilience.ladder` — precomputed QoE-ranked fallback
  plans per single-device-loss scope (``FallbackLadder`` for
  ``ServeSession``, ``FleetLadder`` for ``FleetSession``).
- :mod:`repro_torch.resilience.engine` — the chaos serving engine: pumps a
  real ``runtime.heartbeat.Coordinator`` over the beat grid so a crash
  at ``t`` is only acted on at ``t + miss_limit*beat_interval``, fails
  or times out blind-window requests, re-queues them through the
  recovered plan, and records failed/retried/hedged counts plus MTTR.

Entry point: ``dora.simulate(sc, mode="requests", faults=...)`` (or
``sim.serving.simulate_requests(..., faults=...)`` directly).
"""
from .faults import (Fault, FaultScript, ResilienceConfig, RetryPolicy,
                     split_timeline)
from .ladder import FallbackLadder, FleetLadder, LadderEntry

__all__ = [
    "Fault",
    "FaultScript",
    "RetryPolicy",
    "ResilienceConfig",
    "split_timeline",
    "FallbackLadder",
    "FleetLadder",
    "LadderEntry",
]
