# A copy of src/repro/control/battery.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's reactions must match the reference's action for action.
"""Battery state of charge as a depletable per-device resource.

Edge fleets are not wall-powered: a phone or battery-backed board has a
finite energy budget (``DeviceProfile.battery_j``), and a plan that
looks QoE-optimal on paper dies mid-horizon when the device it leans on
empties.  :class:`BatteryTracker` integrates the serving kernel's
per-device energy attribution (idle draw over presence + the per-request
service energy the kernel already books) against those budgets, so the
control plane can re-cost and re-rank plans *before* the battery event
(:meth:`repro_torch.control.plane.ControlPlane.on_soc`) instead of reacting
to a dead device after the fact.

The tracker is deliberately simulator-side: it consumes the same
``stream.service_energy`` dictionary every trace already reports, so
battery accounting and trace energy accounting can never diverge.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

__all__ = ["SOC_CHECK_LABEL", "BatteryTracker"]

#: timeline label marking an injected SoC checkpoint; the serving
#: simulator intercepts it before the (content-free) event would reach
#: the session's reaction path
SOC_CHECK_LABEL = "__soc_check__"


class BatteryTracker:
    """Integrates per-device drain against finite battery capacities.

    Only devices with ``battery_j is not None`` are tracked; everything
    else is treated as wall-powered.  ``advance`` bills idle draw for
    present devices over the elapsed interval and absorbs the kernel's
    cumulative service-energy attribution as deltas, then reports which
    devices crossed their capacity.
    """

    def __init__(self, devices: Sequence) -> None:
        self.capacity: Dict[int, float] = {
            d: float(dev.battery_j) for d, dev in enumerate(devices)
            if getattr(dev, "battery_j", None) is not None}
        self.p_idle: Dict[int, float] = {
            d: devices[d].p_idle for d in self.capacity}
        self.drained: Dict[int, float] = {d: 0.0 for d in self.capacity}
        self._seen: Dict[int, float] = {d: 0.0 for d in self.capacity}
        self._rate: Dict[int, float] = {d: 0.0 for d in self.capacity}
        self.dead: Set[int] = set()
        self.last_t = 0.0

    def advance(self, t: float, service_energy: Dict[int, float],
                present) -> List[int]:
        """Integrate drain up to ``t``; returns devices that just died.

        ``service_energy`` is the kernel stream's cumulative per-device
        service energy (original device ids); ``present`` the set of
        devices currently in the fleet (absent devices stop draining).
        """
        dt = max(float(t) - self.last_t, 0.0)
        newly: List[int] = []
        for d in self.capacity:
            if d in self.dead:
                continue
            before = self.drained[d]
            if d in present and dt > 0.0:
                self.drained[d] += self.p_idle[d] * dt
            se = float(service_energy.get(d, 0.0))
            if se > self._seen[d]:
                self.drained[d] += se - self._seen[d]
                self._seen[d] = se
            if dt > 0.0:
                inst = (self.drained[d] - before) / dt
                prev = self._rate[d]
                # EMA-smoothed: service energy arrives in bursts, and a
                # raw per-interval rate makes the death projection
                # flap between checkpoints
                self._rate[d] = inst if prev <= 0.0 \
                    else 0.5 * inst + 0.5 * prev
            if self.drained[d] >= self.capacity[d]:
                self.dead.add(d)
                newly.append(d)
        self.last_t = float(t)
        return newly

    def remaining(self, d: int) -> float:
        return max(self.capacity[d] - self.drained[d], 0.0)

    def time_to_death(self, d: int) -> Optional[float]:
        """Projected seconds until ``d`` empties at its last observed
        drain rate; ``None`` when no drain has been observed yet."""
        if d in self.dead:
            return 0.0
        rate = self._rate.get(d, 0.0)
        if rate <= 0.0:
            return None
        return self.remaining(d) / rate

    def soc(self, d: int) -> float:
        """State of charge in [0, 1]."""
        return self.remaining(d) / self.capacity[d]
