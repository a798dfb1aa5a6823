# A copy of src/repro/resilience/ladder.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's chaos traces must match the reference's event for event.
"""Degraded-plan fallback ladder: precomputed recovery per loss scope.

Naive replan-on-detect pays the full planner latency *plus* a cold
weight load on the critical path — the crashed pipeline cannot serve
while the replacement is prepared.  The ladder instead precomputes, at
arm time (and again in the background after every adoption), one
QoE-ranked fallback plan per likely failure scope — each surviving
subset from a single-device loss — so detection switches instantly:
the fallback's weights are prestaged on the survivors, and the only
stall is the pipeline drain.

``FallbackLadder`` serves a single :class:`~repro_torch.dora.ServeSession`;
``FleetLadder`` precomputes whole fleet assignments for a
:class:`~repro_torch.fleet.session.FleetSession`.  A scope with no
QoE-feasible fallback is recorded as infeasible — the engine then
degrades gracefully (brownout: shed batch admissions, keep
interactive) instead of raising.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Tuple

from ..core.planner import DoraPlanner


@dataclasses.dataclass
class LadderEntry:
    """One precomputed fallback: the best plan on ``keep`` after losing
    ``lost``. ``result is None`` marks an infeasible scope (survivors
    disconnect, or nothing plannable); ``qoe_ok`` is the QoE verdict of
    the fallback (False → adopt it but report brownout pressure)."""

    lost: FrozenSet[int]
    keep: Tuple[int, ...]
    mapping: Dict[int, int] = dataclasses.field(default_factory=dict)
    planner: Optional[DoraPlanner] = None
    result: Optional[object] = None
    qoe_ok: bool = False

    @property
    def feasible(self) -> bool:
        return self.result is not None


class FallbackLadder:
    """Per-scope fallback plans for one ``ServeSession``."""

    def __init__(self, session):
        self.session = session
        self.entries: Dict[FrozenSet[int], LadderEntry] = {}
        self.build()

    def build(self) -> None:
        """(Re)compute one fallback per single-device loss from the
        session's current fleet — the warm background replan that runs
        after every adoption."""
        self.entries = {}
        session = self.session
        if session.degraded or len(session.active) <= 1:
            return
        for d in session.active:
            lost = frozenset({d})
            keep = tuple(x for x in session.active if x != d)
            self.entries[lost] = self._build_entry(lost, keep)

    def _build_entry(self, lost: FrozenSet[int],
                     keep: Tuple[int, ...]) -> LadderEntry:
        session = self.session
        report = session.report
        try:
            sub, mapping = report.topology.subset(keep)
            planner = DoraPlanner(
                report.graph, sub, report.qoe,
                partitioner_config=session.partitioner_config,
                scheduler_config=session.scheduler_config,
                adapter_config=session.adapter.config)
            trans = {pos: mapping[orig]
                     for pos, orig in enumerate(session.plan_fleet)
                     if orig in mapping}
            result = planner.replan(report.workload, session.plans,
                                    mapping=trans)
        except (ValueError, RuntimeError):
            # survivors disconnect the routed topology or admit no plan:
            # the scope is infeasible — detection will brown out instead
            return LadderEntry(lost=lost, keep=keep)
        return LadderEntry(lost=lost, keep=keep, mapping=mapping,
                           planner=planner, result=result,
                           qoe_ok=report.qoe.satisfied(result.best))

    def lookup(self, lost) -> Optional[LadderEntry]:
        return self.entries.get(frozenset(lost))

    def apply(self, lost) -> Optional[float]:
        """Switch the session to the precomputed fallback for ``lost``.

        Returns the stall (drain only — fallback weights are
        prestaged), or ``None`` when no feasible entry exists for this
        exact scope (caller falls back to naive replan / brownout).
        Adoption itself lives on the control plane
        (:meth:`ControlPlane.adopt_fallback`).
        """
        entry = self.lookup(lost)
        if entry is None or entry.result is None:
            return None
        return self.session.plane.adopt_fallback(entry)


class FleetLadder:
    """Per-scope fallback fleet assignments for one ``FleetSession``."""

    def __init__(self, session):
        self.session = session
        self.entries: Dict[FrozenSet[int], object] = {}
        self.build()

    def build(self) -> None:
        self.entries = {}
        session = self.session
        n_tenants = len(session.planner.tenants)
        for d in session.active:
            fleet = sorted(set(session.active) - {d})
            if len(fleet) < n_tenants:
                continue        # infeasible scope: not enough devices
            warm = {name: (list(sess.plans),
                           session.plan.tenants[name].allotment)
                    for name, sess in session.sessions.items()}
            merged = session.state
            conditions = merged if (merged.compute_speed
                                    or merged.bandwidth_scale) else None
            try:
                self.entries[frozenset({d})] = session.planner.plan(
                    devices=fleet, warm=warm, conditions=conditions)
            except (ValueError, RuntimeError):
                continue        # no feasible assignment without d

    def lookup(self, lost):
        return self.entries.get(frozenset(lost))

    def apply(self, lost) -> Optional[list]:
        """Adopt the precomputed fleet plan for ``lost``: every moved
        tenant pays only the drain (fallback weights are prestaged).
        Returns the tenant actions, or ``None`` when no entry covers
        the scope.  Adoption itself lives on the control plane
        (:meth:`FleetControlPlane.adopt_fallback`)."""
        new_plan = self.lookup(lost)
        if new_plan is None:
            return None
        return self.session.plane.adopt_fallback(lost, new_plan)
