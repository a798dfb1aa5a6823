# Mirror of tests/test_resilience.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Resilience layer tests: fault model, detection-latency-aware chaos
serving, retry/hedging semantics, the fallback ladder, graceful
degradation, and the no-fault parity contract.

The chaos engine (``repro_torch.resilience.engine``) is only entered when
fault content is present — the plain serving kernel path must stay
bit-identical (locked here and by the existing golden/chunk tests).
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch import dora
from repro_torch.core.adapter import DynamicsEvent
from repro_torch.core.device import CATALOG, Topology
from repro_torch.core.events import ActivePlan, ServingLoad, interactive_batch
from repro_torch.core.graph_builders import GraphSpec, build_lm_graph
from repro_torch.core.cost_model import Workload
from repro_torch.core.qoe import QoESpec
from repro_torch.resilience import (Fault, FaultScript, ResilienceConfig,
                              RetryPolicy, split_timeline)
from repro_torch.resilience.engine import ResilientStream, plan_link_resources
from repro_torch.resilience.ladder import FallbackLadder
from repro_torch.runtime.heartbeat import Coordinator
from repro_torch.scenarios.generate import generate
from repro_torch.sim.serving import simulate_requests
from torch_parity import use_clock

SPEC = GraphSpec("small", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                 d_ff=2048, vocab=8000, seq_len=256)


def chaos_scenario(**qoe_kw):
    """Three phones on WiFi, big enough that the best plan spans two
    devices — so crashing a plan device actually breaks service."""
    qoe = QoESpec(**{"t_qoe": 5.0, "lam": 10.0, **qoe_kw})
    return dora.Scenario(
        name="chaos_fixture",
        description="3 phones on WiFi (resilience fixture)",
        topology=lambda: Topology.shared_medium(
            [CATALOG["s25"], CATALOG["mi15"], CATALOG["genio520"]], 300.0),
        model=lambda seq_len: build_lm_graph(SPEC, seq_len=seq_len),
        workload=Workload(global_batch=8, microbatch_size=2,
                          optimizer_mult=3.0),
        qoe=qoe, seq_len=256, request_rate=2.0)


def line_scenario():
    """Three boards on a line: removing the middle device disconnects
    the survivors (the ``Topology.subset`` cut-vertex case)."""
    return dora.Scenario(
        name="line_fixture",
        description="3 boards on a line (cut-vertex fixture)",
        topology=lambda: Topology.line(
            [CATALOG["genio720"], CATALOG["genio520"], CATALOG["genio520"]],
            500.0),
        model=lambda seq_len: build_lm_graph(SPEC, seq_len=seq_len),
        workload=Workload(global_batch=4, microbatch_size=1),
        qoe=QoESpec(t_qoe=8.0, lam=10.0), seq_len=256, request_rate=1.0)


@pytest.fixture(scope="module")
def chaos_session():
    return dora.serve(chaos_scenario())


def plan_devices(session):
    return sorted({d for s in session.current.stages for d in s.devices})


# -- fault model ----------------------------------------------------------------
def test_fault_validation():
    with pytest.raises(ValueError):
        Fault("meteor", 1.0, 0)
    with pytest.raises(TypeError):
        Fault("link_flap", 1.0, 3)          # link target must be a name
    with pytest.raises(TypeError):
        Fault("crash", 1.0, "wifi")         # device target must be an id
    f = Fault("crash", 2.0, 1, duration=10.0)
    assert f.repair_t == 12.0
    assert Fault("crash", 2.0, 1).repair_t is None


def test_fault_script_compiles_onsets_and_repairs():
    script = FaultScript((
        Fault("straggler", 30.0, 2, duration=10.0, factor=0.4),
        Fault("crash", 5.0, 1, duration=20.0),
        Fault("link_flap", 12.0, "wifi", duration=8.0),
    ))
    evs = script.events()
    assert [e.t for e in evs] == sorted(e.t for e in evs)
    # crash onset is silent; the repair is an *announced* join
    crash = next(e for e in evs if e.crash)
    assert crash.t == 5.0 and not crash.is_announced and crash.is_fault
    rejoin = next(e for e in evs if e.join)
    assert rejoin.t == 25.0 and rejoin.is_announced
    assert any(e.link_down == ("wifi",) for e in evs)
    assert any(e.link_up == ("wifi",) for e in evs)
    recover = [e for e in evs if e.straggler.get(2) == 1.0]
    assert recover and recover[0].t == 40.0


def test_fault_script_random_deterministic():
    sc = chaos_scenario()
    a = FaultScript.random(sc, seed=3)
    b = FaultScript.random(sc, seed=3)
    assert a.faults == b.faults
    assert a.name == "chaos_fixture/chaos-3"
    # scripts always carry at least one crash (service-affecting bias)
    assert any(f.kind == "crash" for f in a.faults)
    assert all(f.kind in ("crash", "link_flap", "straggler")
               for f in a.faults)


def test_fault_script_for_session_targets_plan_devices(chaos_session):
    devs = plan_devices(chaos_session)
    for seed in range(5):
        script = FaultScript.for_session(chaos_session, seed=seed)
        for f in script.faults:
            if f.kind == "crash":
                assert f.target in devs


def test_dynamics_event_fault_flags():
    ev = DynamicsEvent(t=1.0, crash=(2,))
    assert ev.is_fault and not ev.is_announced and not ev.is_churn
    assert ev.magnitude() == 0.0            # invisible to announced path
    mixed = DynamicsEvent(t=1.0, straggler={1: 0.5},
                          bandwidth_scale={"wifi": 0.7})
    assert mixed.is_fault and mixed.is_announced
    announced, faults = split_timeline([mixed])
    assert len(announced) == 1 and len(faults) == 1
    assert not announced[0].is_fault and announced[0].bandwidth_scale
    assert not faults[0].is_announced and faults[0].straggler == {1: 0.5}


def test_retry_policy_backoff_caps():
    p = RetryPolicy(backoff_s=0.5, backoff_mult=2.0, backoff_cap_s=3.0)
    assert p.backoff(2) == 0.5              # first retry
    assert p.backoff(3) == 1.0
    assert p.backoff(5) == 3.0              # capped
    assert p.resolve_timeout(2.0, 0.1) == 6.0
    assert RetryPolicy(timeout_s=9.0).resolve_timeout(2.0, 0.1) == 9.0
    assert ResilienceConfig(beat_interval=0.5,
                            miss_limit=4).detection_window_s == 2.0


# -- detection latency ----------------------------------------------------------
def test_crash_detected_one_window_late(chaos_session):
    """A crash at t is only *acted on* at the first beat past
    t + miss_limit * beat_interval; blind-window requests retry."""
    sc = chaos_scenario()
    onset = 10.5
    victim = plan_devices(chaos_session)[-1]
    cfg = ResilienceConfig(beat_interval=1.0, miss_limit=3)
    tr = dora.simulate(sc, mode="requests", session=chaos_session,
                       copy=True, faults=[DynamicsEvent(t=onset,
                                                        crash=(victim,))],
                       resilience=cfg,
                       load=ServingLoad(rate=4.0, n_requests=200, seed=1))
    [rec] = tr.faults
    assert rec["kind"] == "crash" and rec["affected"]
    # detection lands on the beat grid, one window after onset
    assert rec["detect_t"] == 14.0
    detect = [a for a in tr.actions if a.label.startswith("detected")]
    assert detect and detect[0].t == 14.0
    # nothing reacted before detection (the fault was unobserved)
    pre = [a for a in tr.actions if a.t < rec["detect_t"]]
    assert all(a.action == "unobserved" for a in pre)
    # the blind window cost is visible: retried requests + MTTR
    assert tr.n_retried > 0
    assert tr.requests.attempts is not None
    assert tr.mttr_s is not None and tr.mttr_s >= cfg.detection_window_s


def test_straggler_is_silent_until_detected(chaos_session):
    """A silent slowdown never fails requests — it stretches their true
    latency until the detector realigns belief with truth."""
    sc = chaos_scenario()
    victim = plan_devices(chaos_session)[-1]
    script = FaultScript((Fault("straggler", 8.0, victim,
                                duration=30.0, factor=0.3),))
    tr = dora.simulate(sc, mode="requests", session=chaos_session,
                       copy=True, faults=script,
                       load=ServingLoad(rate=4.0, n_requests=200, seed=1))
    assert tr.n_failed == 0
    [rec] = tr.faults
    assert rec["kind"] == "straggler" and rec["affected"]
    assert rec["detect_t"] is not None and rec["mttr_s"] is not None
    # served requests during the slowdown paid the true latency
    base = dora.simulate(sc, mode="requests", session=chaos_session,
                         copy=True,
                         load=ServingLoad(rate=4.0, n_requests=200, seed=1))
    assert tr.p99 > base.p99


# -- retries, hedging, brownout --------------------------------------------------
def test_blind_requests_fail_and_hedge_interactive(chaos_session):
    sc = chaos_scenario()
    victim = plan_devices(chaos_session)[-1]
    classes = interactive_batch(1.0, 20.0)
    load = ServingLoad(rate=4.0, n_requests=300, seed=2, classes=classes)
    tr = dora.simulate(sc, mode="requests", session=chaos_session,
                       copy=True,
                       faults=[DynamicsEvent(t=10.0, crash=(victim,))],
                       load=load)
    assert tr.n_retried > 0
    # hedged retries are an interactive-class privilege
    assert tr.n_hedged > 0
    cid = tr.requests.class_id
    hedged_classes = {tr.requests.classes[int(c)].name
                      for c in cid[tr.requests.hedged]}
    assert hedged_classes == {"interactive"}
    d = tr.to_dict()
    assert d["retried_requests"] == tr.n_retried
    assert d["hedged_requests"] == tr.n_hedged
    assert d["faults"][0]["kind"] == "crash"


def test_resilient_stream_modes():
    """Unit semantics of the chaos admission queue: blind times out,
    down fails fast with backoff, brownout sheds batch only."""
    ap = ActivePlan(latency=0.1, interval=0.05, per_device_energy={0: 1.0},
                    non_idle_energy={0: 0.5}, compute_busy={0: 0.05},
                    devices=(0,))
    classes = interactive_batch(1.0, 20.0)
    class_id = np.array([0, 1, 0, 1])
    policy = RetryPolicy(timeout_s=2.0, max_retries=1, hedge=True)
    s = ResilientStream(np.array([0.0, 0.1, 0.2, 0.3]), ap, policy=policy,
                        slo_s=1.0, classes=classes, class_id=class_id)
    s.mode = "brownout"
    s.drain()
    served = np.isfinite(s.finish)
    # batch shed (never retried), interactive served
    assert list(served) == [True, False, True, False]
    assert s.attempts[1] == 1               # shed, not retried

    s2 = ResilientStream(np.array([0.0, 0.1]), ap, policy=policy,
                         slo_s=1.0, classes=classes,
                         class_id=np.array([0, 1]))
    s2.mode = "blind"
    s2.serve_to(1.0)                        # both issued into the void
    s2.mode = "ok"
    s2.drain()
    assert np.all(np.isfinite(s2.finish))
    assert np.all(s2.attempts == 2)         # one failed attempt each
    assert bool(s2.hedged[0]) and not bool(s2.hedged[1])
    # the interactive retry re-issued immediately; batch waited backoff
    assert s2.start[0] < s2.start[1]


def test_break_pipeline_refails_inflight():
    ap = ActivePlan(latency=5.0, interval=0.5, per_device_energy={0: 1.0},
                    non_idle_energy={0: 0.5}, compute_busy={0: 0.5},
                    devices=(0,))
    s = ResilientStream(np.array([0.0]), ap,
                        policy=RetryPolicy(timeout_s=3.0, max_retries=2),
                        slo_s=1.0)
    s.serve_to(0.5)                         # booked: finish at 5.0
    assert math.isfinite(s.finish[0])
    s.break_pipeline(1.0)                   # fault before it finished
    assert not math.isfinite(s.finish[0])
    s.mode = "ok"
    s.drain()                               # retried after the timeout
    assert s.attempts[0] == 2 and math.isfinite(s.finish[0])
    assert s.start[0] >= 3.0                # noticed at issued + timeout


# -- fallback ladder -------------------------------------------------------------
def test_fallback_ladder_covers_single_losses(chaos_session):
    import copy as _copy
    session = _copy.deepcopy(chaos_session)
    ladder = FallbackLadder(session)
    assert set(ladder.entries) == {frozenset({d})
                                   for d in session.active}
    victim = plan_devices(session)[-1]
    entry = ladder.lookup({victim})
    assert entry is not None and entry.feasible
    stall = ladder.apply({victim})
    assert stall is not None
    assert victim not in session.active
    assert session.current.meta.get("fallback") is True
    assert session.current.meta["fleet"] == list(entry.keep)


def test_ladder_beats_naive_on_mttr(chaos_session, monkeypatch):
    # the MTTRs add measured reaction seconds: both recoveries read one
    # deterministic clock (torch_parity), so the verdict is the model's,
    # not the machine load's, and a rerun gives the same trace
    clock = use_clock(monkeypatch, "repro_torch")
    sc = chaos_scenario()
    script = FaultScript.for_session(chaos_session, seed=0)
    load = ServingLoad(rate=4.0, n_requests=300, seed=0)
    mttr = {}
    for rec in ("ladder", "replan", "ladder"):
        clock.reset()
        tr = dora.simulate(sc, mode="requests", session=chaos_session,
                           copy=True, faults=script, recovery=rec,
                           load=load)
        assert tr.mttr_s is not None
        if rec in mttr:
            assert tr.to_dict() == mttr[rec][1]
        mttr[rec] = (tr.mttr_s, tr.to_dict())
    assert mttr["ladder"][0] <= mttr["replan"][0]


def test_plan_link_resources_spans_route():
    topo = Topology.line([CATALOG["genio720"], CATALOG["genio520"],
                          CATALOG["genio520"]], 500.0)
    report = dora.plan(line_scenario())
    links = plan_link_resources(report.best, range(topo.n), topo)
    # single-stage plans on one device use no links; multi-stage plans
    # must name at least one — either way the call is total
    assert isinstance(links, frozenset)


# -- graceful degradation (satellite: disconnecting churn) -----------------------
def test_disconnecting_churn_degrades_then_recovers():
    """Before the fix: ``Topology.subset``'s ValueError propagated out of the
    session. Now: the segment goes QoE-infeasible and a rejoin
    recovers."""
    session = dora.serve(line_scenario())
    # removing the middle device (1) disconnects survivors {0, 2}
    plan, act, _ = session.on_dynamics(DynamicsEvent(t=5.0, leave=(1,)))
    assert act == "degraded"
    assert session.degraded and not session.meets_qoe
    assert session.active == (0, 2)
    # conditions during the outage are absorbed, not crashed on
    _, act2, _ = session.on_dynamics(
        DynamicsEvent(t=6.0, compute_speed={0: 0.8}))
    assert act2 == "degraded"
    # the rejoin replans from the pre-churn fleet and recovers
    plan3, act3, _ = session.on_dynamics(DynamicsEvent(t=30.0, join=(1,)))
    assert act3 == "replan"
    assert not session.degraded and session.meets_qoe
    assert session.active == (0, 1, 2)


def test_degraded_serving_trace_fails_requests():
    sc = line_scenario()
    tr = simulate_requests(
        sc, events=[DynamicsEvent(t=5.0, leave=(1,)),
                    DynamicsEvent(t=40.0, join=(1,))],
        load=ServingLoad(rate=2.0, n_requests=150, seed=0))
    acts = [a.action for a in tr.actions]
    assert "degraded" in acts and "replan" in acts
    assert tr.n_failed > 0                  # outage window is honest


# -- coordinator re-election (satellite) -----------------------------------------
def test_coordinator_reelection_exposes_new_coordinator():
    """Killing device 0 (the coordinator) re-elects the lowest healthy
    id and exposes it on the failure callback."""
    calls = []
    c = Coordinator([0, 1, 2], beat_interval=1.0, miss_limit=3,
                    on_failure=lambda failed, coord: calls.append(
                        (list(failed), coord)))
    for t in (1.0, 2.0, 3.0, 4.0):
        c.beat(1, t)
        c.beat(2, t)                        # device 0 silent from t=0
    assert c.tick(4.5) == [0]
    assert c.coordinator_id == 1
    assert calls == [([0], 1)]              # new coordinator exposed
    # a revived lower id reclaims the role
    c.beat(0, 6.0)
    assert c.coordinator_id == 0


def test_coordinator_reelection_survives_total_wipe():
    c = Coordinator([0, 1, 2], beat_interval=1.0, miss_limit=1)
    assert sorted(c.tick(10.0)) == [0, 1, 2]
    assert c.healthy == []
    c.beat(2, 11.0)                        # only device 2 comes back
    assert c.coordinator_id == 2


def test_coordinator_legacy_one_arg_callback():
    seen = []
    c = Coordinator([0, 1], beat_interval=1.0, miss_limit=1,
                    on_failure=lambda failed: seen.extend(failed))
    c.beat(1, 3.0)
    assert c.tick(3.5) == [0]
    assert seen == [0]


# -- no-fault parity -------------------------------------------------------------
def test_no_fault_path_untouched(chaos_session):
    """faults=None / an empty script never routes to the chaos engine:
    the trace is bit-identical and carries no resilience arrays."""
    sc = chaos_scenario()
    load = ServingLoad(rate=2.0, n_requests=200, seed=0)
    base = dora.simulate(sc, mode="requests", session=chaos_session,
                         copy=True, load=load)
    empty = dora.simulate(sc, mode="requests", session=chaos_session,
                          copy=True, load=load, faults=FaultScript(()))
    assert base.requests.attempts is None
    assert empty.requests.attempts is None
    assert base.faults == [] and base.mttr_s is None
    np.testing.assert_array_equal(base.requests.start,
                                  empty.requests.start)
    np.testing.assert_array_equal(base.requests.finish,
                                  empty.requests.finish)
    assert base.per_device_energy == empty.per_device_energy
    assert "faults" not in base.to_dict()


# -- property: chaos never crashes ----------------------------------------------
def test_chaos_property_no_uncaught_exceptions():
    """100+ seeded fault scripts across scenarios and recovery modes:
    every run completes with a well-formed, JSON-serializable trace."""
    import json
    n_scripts = 0
    cases = [(chaos_scenario(), None),
             (generate("faulty_sites", 16), None),
             (generate("faulty_sites", 8), None),
             (line_scenario(), None)]
    load = ServingLoad(rate=2.0, n_requests=80, seed=0)
    for sc, _ in cases:
        session = dora.serve(sc)
        for seed in range(26):
            script = (FaultScript.for_session(session, seed=seed)
                      if seed % 2 else FaultScript.random(sc, seed=seed))
            recovery = ("ladder", "replan")[seed % 2]
            tr = dora.simulate(sc, mode="requests", session=session,
                               copy=True, faults=script, recovery=recovery,
                               load=load)
            n_scripts += 1
            # invariants: arrays aligned, verdicts well-formed,
            # serializable
            assert len(tr.requests.attempts) == len(tr.requests)
            assert tr.n_failed >= 0 and 0.0 <= tr.slo_attainment <= 1.0
            assert all(f["kind"] in ("crash", "link_down", "straggler")
                       for f in tr.faults)
            json.dumps(tr.to_dict())
            # second run of the same script is deterministic up to
            # measured replanning wall time (react_s is real seconds)
            if seed == 0:
                tr2 = dora.simulate(sc, mode="requests", session=session,
                                    copy=True, faults=script,
                                    recovery=recovery, load=load)
                assert tr2.n_failed == tr.n_failed
                assert [f["detect_t"] for f in tr2.faults] \
                    == [f["detect_t"] for f in tr.faults]
                np.testing.assert_allclose(tr2.requests.finish,
                                           tr.requests.finish, atol=1.0)
    assert n_scripts >= 100


# -- fleet chaos ----------------------------------------------------------------
def test_fleet_chaos_smoke(monkeypatch):
    # the MTTRs compared below add measured reaction seconds: read one
    # deterministic clock (torch_parity)
    clock = use_clock(monkeypatch, "repro_torch")
    fs_sess = dora.serve_fleet("smart_home_assist")
    script = FaultScript((Fault("crash", 8.0, 1, duration=30.0),
                          Fault("straggler", 50.0, 2, duration=25.0,
                                factor=0.4)))
    traces = {}
    for rec in ("ladder", "replan"):
        clock.reset()
        tr = dora.simulate("smart_home_assist", mode="fleet",
                           session=fs_sess, copy=True, faults=script,
                           recovery=rec, seed=1)
        assert set(tr.tenants) == {"voice_assistant", "vision_monitor"}
        assert tr.mttr_s is not None
        assert all(t.requests.attempts is not None
                   for t in tr.tenants.values())
        import json
        json.dumps(tr.to_dict())
        traces[rec] = tr
    assert traces["ladder"].mttr_s <= traces["replan"].mttr_s * 1.5
