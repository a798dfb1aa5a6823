# A copy of src/repro/core/qoe.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""QoE specifications and Dora's Lagrangian-relaxed objective (Eqs. 1-2)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class QoESpec:
    """User-facing QoE constraints for one workload.

    ``t_qoe``     — end-to-end latency target (sec per training iteration,
                    or sec per generated token for serving).
    ``e_qoe``     — per-device energy budget (J per iteration/token);
                    ``None`` means unconstrained.
    ``m_qoe``     — optional per-device memory cap override (bytes);
                    device memory from the profile is always enforced.
    ``lam``       — λ in Eq. (2): price of one second of QoE violation in
                    joules.
    ``deadline``  — optional long-horizon deadline (sec) for the runtime
                    adapter's uniform-progress heuristic (§4.3).
    """

    t_qoe: float = math.inf
    e_qoe: Optional[float] = None
    m_qoe: Optional[float] = None
    lam: float = 1.0
    deadline: Optional[float] = None

    def objective(self, energy: float, latency: float) -> float:
        """Eq. (2): total energy + λ · (T_plan − T_QoE)_+ ."""
        violation = max(0.0, latency - self.t_qoe)
        return energy + self.lam * violation

    def feasible_memory(self, per_device_bytes: Dict[int, float],
                        device_memory: Dict[int, float]) -> bool:
        for i, used in per_device_bytes.items():
            cap = device_memory[i]
            if self.m_qoe is not None:
                cap = min(cap, self.m_qoe)
            if used > cap:
                return False
        return True

    def feasible_energy(self, per_device_energy: Dict[int, float]) -> bool:
        if self.e_qoe is None:
            return True
        return all(e <= self.e_qoe for e in per_device_energy.values())

    def satisfied(self, plan,
                  device_memory: Optional[Dict[int, float]] = None) -> bool:
        """Full QoE verdict for one evaluated ``ParallelismPlan``: the
        latency target AND the per-device energy budget AND (when a cap
        applies) per-device memory — a plan that blows its energy budget
        does not "meet QoE" just because it is fast. ``device_memory``
        optionally supplies hardware memory caps; without it, memory is
        checked against ``m_qoe`` alone (the planner already enforces
        hardware caps at construction time).
        """
        if plan.latency > self.t_qoe:
            return False
        if not self.feasible_energy(plan.per_device_energy):
            return False
        caps = device_memory
        if caps is None and self.m_qoe is not None:
            caps = {d: math.inf for d in plan.per_device_memory}
        if caps is not None and not self.feasible_memory(plan.per_device_memory,
                                                        caps):
            return False
        return True
