# A copy of src/repro/resilience/faults.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's chaos traces must match the reference's event for event.
"""Fault model: seeded fault scripts, retry policy, resilience knobs.

A :class:`Fault` is one unannounced failure occurrence; a
:class:`FaultScript` is an ordered, seeded collection of them that
compiles to ``DynamicsEvent`` onsets (silent — carrying only the new
``crash`` / ``link_down`` / ``link_up`` / ``straggler`` fields) plus
*announced* repair events (a crashed device that comes back rejoins
through the ordinary churn path, because a rebooted device says hello).

Scripts compose with the generated scenario families: pass
``faults=FaultScript.random(sc, seed=0)`` to ``dora.simulate(...,
mode="requests")``, or use the ``faulty_sites`` generator family whose
timelines already carry fault events.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.adapter import DynamicsEvent

FAULT_KINDS = ("crash", "link_flap", "straggler")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One unannounced failure occurrence.

    kind      -- "crash" (device stops silently), "link_flap" (a link
                 resource goes down for a duration), or "straggler"
                 (silent slowdown; the device keeps heartbeating its
                 *nominal* speed, so the planner's believed state is
                 wrong until the slowdown is detected).
    t         -- onset time (seconds into the run).
    target    -- device id (crash/straggler) or link resource name
                 (link_flap).
    duration  -- seconds until repair; ``None`` means the fault lasts
                 to the end of the run.
    factor    -- straggler speed multiplier (< 1.0 is slower); ignored
                 for the other kinds.
    """

    kind: str
    t: float
    target: object
    duration: Optional[float] = None
    factor: float = 0.5

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "link_flap" and not isinstance(self.target, str):
            raise TypeError("link_flap target must be a link resource name")
        if self.kind in ("crash", "straggler") and not isinstance(self.target, int):
            raise TypeError(f"{self.kind} target must be a device id")

    @property
    def repair_t(self) -> Optional[float]:
        return None if self.duration is None else self.t + self.duration

    def describe(self) -> str:
        tail = "" if self.duration is None else f" for {self.duration:g}s"
        if self.kind == "straggler":
            return f"straggler: {self.target}->x{self.factor:g}{tail}"
        noun = "crash" if self.kind == "crash" else "link down"
        return f"{noun}: {self.target}{tail}"


@dataclasses.dataclass(frozen=True)
class FaultScript:
    """An ordered, seeded set of faults for one chaos run."""

    faults: Tuple[Fault, ...]
    name: str = ""
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "faults",
                           tuple(sorted(self.faults, key=lambda f: f.t)))

    def events(self) -> List[DynamicsEvent]:
        """Compile to a timeline of ``DynamicsEvent``s.

        Onsets are silent (fault fields only). Repairs are announced:
        a crashed device rejoins via ``join`` (a rebooted device
        re-registers), a flapped link comes back via ``link_up``, and
        a straggler recovering resets its factor to 1.0.
        """
        out: List[DynamicsEvent] = []
        for f in self.faults:
            if f.kind == "crash":
                out.append(DynamicsEvent(t=f.t, crash=(f.target,)))
                if f.repair_t is not None:
                    out.append(DynamicsEvent(t=f.repair_t, join=(f.target,)))
            elif f.kind == "link_flap":
                out.append(DynamicsEvent(t=f.t, link_down=(f.target,)))
                if f.repair_t is not None:
                    out.append(DynamicsEvent(t=f.repair_t, link_up=(f.target,)))
            else:  # straggler
                out.append(DynamicsEvent(t=f.t, straggler={f.target: f.factor}))
                if f.repair_t is not None:
                    out.append(DynamicsEvent(t=f.repair_t,
                                             straggler={f.target: 1.0}))
        out.sort(key=lambda ev: ev.t)
        return out

    @classmethod
    def random(cls, scenario, seed: int = 0, *,
               n_faults: Optional[int] = None,
               kinds: Sequence[str] = FAULT_KINDS,
               crashable: Optional[Sequence[int]] = None,
               t0: Tuple[float, float] = (4.0, 20.0),
               gap: Tuple[float, float] = (8.0, 30.0),
               duration: Tuple[float, float] = (10.0, 45.0),
               repair_p: float = 0.7) -> "FaultScript":
        """Seeded fault generator for a scenario.

        Deterministic in ``(scenario.name, seed)``; independent of any
        other RNG stream in the repo. Always includes at least one
        crash when a crashable device exists. Device 0 is excluded
        from the default crash pool (it anchors the plan's first
        stage), but callers may pass ``crashable`` explicitly — e.g.
        ``crashable=[0]`` to exercise coordinator failover.
        """
        rng = random.Random(f"dora-chaos:{getattr(scenario, 'name', scenario)}:{seed}")
        topo = scenario.build_topology()
        n = topo.n
        if crashable is None:
            crashable = list(range(1, n))
        crashable = list(crashable)
        links = sorted({r.name for i in range(n) for j in range(i + 1, n)
                        for r in topo.resources_between(i, j)})
        kinds = [k for k in kinds
                 if not (k == "crash" and not crashable)
                 and not (k == "link_flap" and not links)]
        if not kinds:
            raise ValueError("no applicable fault kinds for this scenario")
        if n_faults is None:
            n_faults = rng.randint(1, 3)
        faults: List[Fault] = []
        t = rng.uniform(*t0)
        order = list(kinds)
        if "crash" in order:            # guarantee one crash per script
            order.remove("crash")
            order.insert(0, "crash")
        for i in range(n_faults):
            kind = order[0] if i == 0 else rng.choice(kinds)
            dur = rng.uniform(*duration) if rng.random() < repair_p else None
            if kind == "crash":
                faults.append(Fault("crash", t, rng.choice(crashable), dur))
            elif kind == "link_flap":
                faults.append(Fault("link_flap", t, rng.choice(links), dur))
            else:
                faults.append(Fault("straggler", t, rng.randrange(n), dur,
                                    factor=rng.uniform(0.2, 0.6)))
            t += rng.uniform(*gap)
        return cls(faults=tuple(faults),
                   name=f"{getattr(scenario, 'name', scenario)}/chaos-{seed}",
                   seed=seed)

    @classmethod
    def for_session(cls, session, seed: int = 0, **kwargs) -> "FaultScript":
        """Seeded faults aimed at an armed ``ServeSession``'s *plan
        devices* — the crashes that actually break service (a crash of
        an idle device exercises detection but affects nothing). The
        chaos bench uses this so every script is service-affecting."""
        from ..core.events import freeze_plan
        frozen = freeze_plan(session.current, session.plan_fleet,
                             session.report.topology)
        kwargs.setdefault("crashable", list(frozen.devices))
        return cls.random(session.report.scenario, seed, **kwargs)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry semantics for failed requests.

    ``timeout_s`` is how long a client waits on a request issued into
    a *broken* (not-yet-detected) pipeline before giving up; ``None``
    derives it per run as ``max(3 * SLO, 5 * plan latency)``. Healthy
    segments never time out, so the no-fault path stays bit-identical
    to the Lindley kernel. Retries back off exponentially (capped);
    hedged retries — enabled for request classes named "interactive" —
    skip the backoff and re-issue immediately.
    """

    timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    backoff_cap_s: float = 8.0
    hedge: bool = True

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (attempt 2 = first retry)."""
        return min(self.backoff_cap_s,
                   self.backoff_s * self.backoff_mult ** max(0, attempt - 2))

    def resolve_timeout(self, slo_s: float, latency_s: float) -> float:
        if self.timeout_s is not None:
            return self.timeout_s
        return max(3.0 * slo_s, 5.0 * latency_s)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the chaos serving engine.

    The detection window is ``miss_limit * beat_interval`` (paper §5):
    a crash at ``t`` is only acted on at the first heartbeat tick after
    ``t + window``. ``link_down_scale`` is the bandwidth scale the
    session *believes* for a detected-down link (near-zero, so replans
    route around it); ``straggler_window_s`` defaults to the detection
    window.
    """

    beat_interval: float = 1.0
    miss_limit: int = 3
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    link_down_scale: float = 0.05

    @property
    def detection_window_s(self) -> float:
        return self.miss_limit * self.beat_interval


def split_timeline(timeline) -> Tuple[List[DynamicsEvent], List[DynamicsEvent]]:
    """Split a normalized timeline into (announced, fault) event lists.

    An event carrying both announced and fault content is split into
    two events at the same ``t`` so each side sees a pure stream.
    """
    announced: List[DynamicsEvent] = []
    faults: List[DynamicsEvent] = []
    for ev in timeline:
        if ev.is_fault and ev.is_announced:
            announced.append(dataclasses.replace(
                ev, crash=(), link_down=(), link_up=(), straggler={}))
            faults.append(DynamicsEvent(t=ev.t, crash=ev.crash,
                                        link_down=ev.link_down,
                                        link_up=ev.link_up,
                                        straggler=dict(ev.straggler)))
        elif ev.is_fault:
            faults.append(ev)
        else:
            announced.append(ev)
    return announced, faults
