# A copy of src/repro/runtime/heartbeat.py (the port imports nothing of the JAX package).
# Keep it verbatim: the chaos engine's detection must match the reference's beat for beat.
"""Coordinator + heartbeat failure detector (paper §5).

The most capable device acts as coordinator; it receives periodic
heartbeats carrying (compute speed factor, available bandwidth). Small
fluctuations (≤ threshold) trigger network-only rescheduling; large ones
trigger full replanning; missed beats mark a device failed and start
consensus-style recovery (deterministic re-election: lowest healthy id).

This module is transport-agnostic (the simulator drives it with a
virtual clock; a real deployment would pump it from RPC callbacks).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional

from ..core.adapter import DynamicsEvent


@dataclasses.dataclass
class DeviceStatus:
    device_id: int
    last_beat: float = 0.0
    speed: float = 1.0          # compute factor (1.0 = nominal)
    bandwidth: float = 1.0      # network factor
    alive: bool = True


class Coordinator:
    def __init__(self, device_ids: List[int], *, beat_interval: float = 1.0,
                 miss_limit: int = 3, fluctuation_threshold: float = 0.10,
                 on_reschedule: Optional[Callable[[DynamicsEvent], None]] = None,
                 on_replan: Optional[Callable[[DynamicsEvent], None]] = None,
                 on_failure: Optional[Callable[[List[int]], None]] = None):
        self.devices = {d: DeviceStatus(d) for d in device_ids}
        self.beat_interval = beat_interval
        self.miss_limit = miss_limit
        self.threshold = fluctuation_threshold
        self.on_reschedule = on_reschedule
        self.on_replan = on_replan
        self.on_failure = on_failure
        self.coordinator_id = min(device_ids)
        self.log: List[str] = []

    # -- election -----------------------------------------------------------------
    def _elect(self, t: float) -> None:
        """Maintain the docstring's invariant: the coordinator is always
        the lowest *healthy* id (a revived lower id reclaims the role; a
        dead coordinator is replaced even when every device failed in
        the same tick and one later returns)."""
        healthy = [d for d, s in self.devices.items() if s.alive]
        if healthy and self.coordinator_id != min(healthy):
            self.coordinator_id = min(healthy)
            self.log.append(f"t={t:.1f} coordinator -> {self.coordinator_id}")

    def _notify_failure(self, failed: List[int]) -> None:
        """Call ``on_failure`` with the new coordinator exposed: two-arg
        callbacks receive ``(failed, coordinator_id)``; legacy one-arg
        callbacks (e.g. ``ElasticController._on_failure``) keep working.
        """
        if self.on_failure is None:
            return
        try:
            n_params = len(inspect.signature(self.on_failure).parameters)
        except (TypeError, ValueError):
            n_params = 1
        if n_params >= 2:
            self.on_failure(failed, self.coordinator_id)
        else:
            self.on_failure(failed)

    # -- heartbeat ingestion ------------------------------------------------------
    def beat(self, device_id: int, t: float, *, speed: float = 1.0,
             bandwidth: float = 1.0) -> None:
        st = self.devices[device_id]
        prev_speed, prev_bw = st.speed, st.bandwidth
        revived = not st.alive
        st.last_beat, st.speed, st.bandwidth, st.alive = t, speed, bandwidth, True
        if revived:
            self._elect(t)
        mag = max(abs(speed - prev_speed), abs(bandwidth - prev_bw))
        if mag == 0.0:
            return
        ev = DynamicsEvent(t=t, compute_speed={device_id: speed},
                           bandwidth_scale={"*": bandwidth})
        if mag <= self.threshold:
            self.log.append(f"t={t:.1f} dev{device_id} fluctuation {mag:.2f} -> reschedule")
            if self.on_reschedule:
                self.on_reschedule(ev)
        else:
            self.log.append(f"t={t:.1f} dev{device_id} shift {mag:.2f} -> replan")
            if self.on_replan:
                self.on_replan(ev)

    # -- failure detection ----------------------------------------------------------
    def tick(self, t: float) -> List[int]:
        """Advance the detector; returns newly-failed device ids."""
        failed = []
        for st in self.devices.values():
            if st.alive and t - st.last_beat > self.miss_limit * self.beat_interval:
                st.alive = False
                failed.append(st.device_id)
        if failed:
            self.log.append(f"t={t:.1f} failed={failed}")
            self._elect(t)                        # re-election before notify
            self._notify_failure(failed)
        return failed

    @property
    def healthy(self) -> List[int]:
        return sorted(d for d, s in self.devices.items() if s.alive)
