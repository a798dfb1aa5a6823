# Mirror of tests/test_serving_sim.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Request-level serving simulator + runtime-adapter dynamics-state fixes.

Covers the ``repro_torch.sim.serving`` queueing model (arrivals, Little's law,
tail-latency monotonicity, churn) and the three adapter bugfix
regressions: cumulative dynamics state, full-QoE verdicts, and
switch-cost-aware replanning.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro_torch import dora
from repro_torch.core.adapter import (AdapterConfig, DynamicsEvent, RuntimeAdapter,
                                RuntimeState)
from repro_torch.core.cost_model import Workload
from repro_torch.core.device import CATALOG, Topology
from repro_torch.core.graph_builders import GraphSpec, build_lm_graph
from repro_torch.core.plans import ParallelismPlan, Stage
from repro_torch.core.qoe import QoESpec
from repro_torch.core.events import poisson_arrivals
from repro_torch.sim.serving import ServingLoad, ServingTrace, simulate_requests

SPEC = GraphSpec("small", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                 d_ff=2048, vocab=8000, seq_len=256)


def tiny_scenario(**qoe_kw):
    """Three phones on WiFi; big enough that the best plan spans two
    devices (so network/compute dynamics actually move latency), small
    enough to plan in ~0.1 s."""
    qoe = QoESpec(**{"t_qoe": 5.0, "lam": 10.0, **qoe_kw})
    return dora.Scenario(
        name="serving_fixture",
        description="3 phones on WiFi (test fixture)",
        topology=lambda: Topology.shared_medium(
            [CATALOG["s25"], CATALOG["mi15"], CATALOG["genio520"]], 300.0),
        model=lambda seq_len: build_lm_graph(SPEC, seq_len=seq_len),
        workload=Workload(global_batch=8, microbatch_size=2,
                          optimizer_mult=3.0),
        qoe=qoe, seq_len=256, request_rate=0.5)


# -- arrival generation ---------------------------------------------------------
def test_poisson_arrivals_deterministic_per_seed():
    a = poisson_arrivals(2.0, 500, seed=7)
    b = poisson_arrivals(2.0, 500, seed=7)
    c = poisson_arrivals(2.0, 500, seed=8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0.0)
    # mean inter-arrival ~ 1/rate (law of large numbers, loose)
    assert np.mean(np.diff(a)) == pytest.approx(0.5, rel=0.2)


def test_poisson_arrivals_scale_coupled_across_rates():
    """Same seed at a higher rate = the same trace compressed pointwise
    (the property that makes tail latency monotone in rate)."""
    slow = poisson_arrivals(1.0, 200, seed=3)
    fast = poisson_arrivals(4.0, 200, seed=3)
    assert np.allclose(fast, slow / 4.0)


def test_poisson_arrivals_rejects_bad_inputs():
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 10)
    with pytest.raises(ValueError):
        poisson_arrivals(1.0, 0)


# -- queueing model -------------------------------------------------------------
def test_little_law_at_low_load():
    """At light load the time-averaged number of requests in the system
    matches λ·W (sampled independently of the bookkeeping that computes
    latencies), and waiting is negligible."""
    sc = tiny_scenario()
    rate = 0.2
    trace = simulate_requests(sc, load=ServingLoad(rate=rate, n_requests=300),
                              events=())
    assert all(r.served for r in trace.requests)
    mean_wait = float(np.mean([r.waiting for r in trace.requests]))
    assert mean_wait < 0.1 * trace.mean_latency
    ts = np.linspace(0.0, trace.horizon_s, 2000, endpoint=False)
    in_system = np.zeros_like(ts)
    for r in trace.requests:
        in_system += (ts >= r.arrival) & (ts < r.finish)
    n_avg = float(np.mean(in_system))
    assert n_avg == pytest.approx(rate * trace.mean_latency, rel=0.3)


def test_p99_monotone_in_arrival_rate():
    sc = tiny_scenario()
    p99s = []
    for rate in (1.0, 2.0, 4.0, 8.0):
        trace = simulate_requests(
            sc, load=ServingLoad(rate=rate, n_requests=150, seed=11),
            events=())
        p99s.append(trace.p99)
    for lo, hi in zip(p99s, p99s[1:]):
        assert hi >= lo - 1e-9, p99s


def test_trace_reports_distribution_and_energy():
    sc = tiny_scenario()
    trace = simulate_requests(sc, load=ServingLoad(rate=1.0, n_requests=50),
                              events=())
    assert trace.p50 <= trace.p95 <= trace.p99
    assert 0.0 <= trace.slo_attainment <= 1.0
    assert trace.energy > 0.0
    assert set(trace.per_device_energy) == {0, 1, 2}   # idle draw for all
    assert all(e > 0.0 for e in trace.per_device_energy.values())
    utils = [trace.utilization(d) for d in (0, 1, 2)]
    assert all(0.0 <= u <= 1.0 for u in utils)
    assert max(utils) > 0.0                  # somebody did the computing
    text = json.dumps(trace.to_dict(), allow_nan=False)   # strict-JSON safe
    assert "slo_attainment" in text


def test_simulate_facade_mode_requests():
    sc = tiny_scenario()
    trace = dora.simulate(sc, mode="requests",
                          load=ServingLoad(rate=1.0, n_requests=20),
                          events=())
    assert isinstance(trace, ServingTrace)
    with pytest.raises(ValueError, match="mode"):
        dora.simulate(sc, mode="nonsense")


# -- churn ----------------------------------------------------------------------
def test_churn_event_triggers_exactly_one_replan():
    sc = tiny_scenario()
    events = [("node 1 leaves", DynamicsEvent(t=20.0, leave=(1,)))]
    trace = simulate_requests(
        sc, load=ServingLoad(rate=1.0, n_requests=60, seed=5), events=events)
    assert [a.action for a in trace.actions] == ["replan"]
    assert trace.replans == 1
    assert all(r.served for r in trace.requests)    # dora keeps serving


def test_churn_shrinks_and_regrows_session_fleet():
    sc = tiny_scenario()
    session = dora.serve(sc)
    assert session.active == (0, 1, 2)
    new, action, _ = session.on_dynamics(DynamicsEvent(t=5.0, leave=(1,)))
    assert action == "replan"
    assert session.active == (0, 2)
    assert 1 not in {session.active[d] for d in new.devices}
    assert new.meta["switch_stall_s"] >= 0.0
    new2, action2, _ = session.on_dynamics(DynamicsEvent(t=9.0, join=(1,)))
    assert action2 == "replan"
    assert session.active == (0, 1, 2)
    # back on the full fleet, the adapter recovers the original latency
    assert new2.latency == pytest.approx(session.report.latency, rel=1e-6)


def test_churn_removing_every_device_raises():
    sc = tiny_scenario()
    session = dora.serve(sc)
    with pytest.raises(ValueError):
        session.on_dynamics(DynamicsEvent(t=1.0, leave=(0, 1, 2)))
    with pytest.raises(ValueError):
        session.on_dynamics(DynamicsEvent(t=1.0, leave=(7,)))


def test_static_strategy_fails_requests_when_its_device_leaves():
    """A contention-oblivious baseline cannot adapt: churn on a device it
    placed layers on fails every request until the device rejoins —
    dora's adapter replans and keeps serving."""
    sc = tiny_scenario()
    report = dora.plan(sc, strategy="chain_split")
    victim = sorted(set(report.best.devices))[-1]
    events = [
        ("victim leaves", DynamicsEvent(t=10.0, leave=(victim,))),
        ("victim rejoins", DynamicsEvent(t=40.0, join=(victim,))),
    ]
    load = ServingLoad(rate=1.0, n_requests=60, seed=2)
    static = simulate_requests(sc, strategy="chain_split", load=load,
                               events=events)
    adaptive = simulate_requests(sc, strategy="dora", load=load,
                                 events=events)
    assert static.n_failed > 0
    assert {a.action for a in static.actions} == {"degraded", "repriced"}
    assert adaptive.n_failed == 0
    assert adaptive.slo_attainment > static.slo_attainment
    # percentiles over failed (inf) requests are inf, never NaN
    for q in (50.0, 95.0, 99.0):
        assert not math.isnan(static.percentile(q))
    assert static.p99 == math.inf
    # failed requests serialize to strict JSON (inf -> null)
    json.dumps(static.to_dict(), allow_nan=False)


def test_idle_energy_billed_only_over_presence_interval():
    """A device that leaves mid-run stops drawing idle power the moment
    it departs and resumes when it rejoins.  Historically the simulator
    billed every fleet device's idle draw over the *full* horizon, so
    leave-heavy timelines overcharged departed devices."""
    sc = tiny_scenario()
    victim = 2                      # dora's plan spans devices {0, 1} only
    leave_t, rejoin_t = 12.0, 30.0
    events = [
        ("victim leaves", DynamicsEvent(t=leave_t, leave=(victim,))),
        ("victim rejoins", DynamicsEvent(t=rejoin_t, join=(victim,))),
    ]
    trace = simulate_requests(
        sc, strategy="dora",
        load=ServingLoad(rate=1.0, n_requests=100, seed=9), events=events)
    horizon = trace.horizon_s
    assert horizon > rejoin_t
    away = rejoin_t - leave_t
    assert trace.per_device_busy.get(victim, 0.0) == 0.0
    assert trace.per_device_idle_s[victim] == pytest.approx(horizon - away)
    for stayed in (0, 1):
        assert trace.per_device_idle_s[stayed] == pytest.approx(horizon)
    # the victim never computes, so its whole bill is idle draw over its
    # presence window — strictly less than the old full-horizon charge
    p_idle = sc.build_topology().devices[victim].p_idle
    assert trace.per_device_energy[victim] == \
        pytest.approx(p_idle * (horizon - away))
    assert trace.per_device_energy[victim] < p_idle * horizon


def test_conditions_on_departed_links_are_filtered():
    """After churn, accumulated bandwidth scales may reference links
    that left with their device; reactions on the shrunk fleet must
    filter them instead of KeyError-ing — and they come back into
    force when the device rejoins."""
    from repro_torch.core.device import LinkResource, MBPS
    devs = [CATALOG["s25"], CATALOG["mi15"], CATALOG["genio520"]]
    wifi = LinkResource("wifi", 300.0 * MBPS, frozenset(range(3)),
                        shared=True, latency=3e-3)
    eth = LinkResource("eth-0-1", 1000.0 * MBPS, frozenset((0, 1)),
                       shared=False, latency=0.3e-3)
    p2p = {(0, 1): ["eth-0-1"], (1, 0): ["eth-0-1"]}
    sc = dataclasses.replace(
        tiny_scenario(),
        topology=lambda: Topology.mixed(devs, [wifi, eth], p2p))
    session = dora.serve(sc)
    session.on_dynamics(DynamicsEvent(t=1.0,
                                      bandwidth_scale={"eth-0-1": 0.5}))
    session.on_dynamics(DynamicsEvent(t=2.0, leave=(1,)))
    assert "eth-0-1" not in session.adapter.topo.resources
    # the accumulated eth scale must not crash reactions on the new fleet
    plan, action, _ = session.on_dynamics(
        DynamicsEvent(t=3.0, bandwidth_scale={"wifi": 0.6}))
    assert action in ("reschedule", "replan")
    assert session.state.bandwidth_scale["eth-0-1"] == 0.5   # remembered
    session.on_dynamics(DynamicsEvent(t=4.0, join=(1,)))
    assert session.active == (0, 1, 2)


def test_topology_subset_reindexes_and_keeps_link_names():
    topo = Topology.shared_medium(
        [CATALOG["s25"], CATALOG["mi15"], CATALOG["genio520"]], 300.0)
    sub, mapping = topo.subset([0, 2])
    assert mapping == {0: 0, 2: 1}
    assert sub.n == 2
    assert "wifi" in sub.resources               # name survives for bw scales
    assert sub.resources["wifi"].members == frozenset({0, 1})
    with pytest.raises(ValueError):
        topo.subset([])
    with pytest.raises(ValueError):
        topo.subset([5])


def test_topology_subset_reroutes_ring_around_departed_node():
    """Removing a middle ring node must re-derive the survivors' routes
    over the remaining links (pre-fix: KeyError 'no route' crashed any
    churn on dedicated-link fleets like vehicle_platoon)."""
    topo = Topology.ring([CATALOG["genio520"]] * 4, 100.0, name="v2v",
                         latency=5e-3)
    sub, m = topo.subset([0, 1, 3])
    route = [r.name for r in sub.resources_between(m[1], m[3])]
    assert sorted(route) == ["v2v-0-1", "v2v-3-0"]   # the long way, via 0
    assert sub.peak_bandwidth(m[1], m[3]) > 0.0
    # a fleet genuinely split in two is an error, not a silent KeyError
    two_islands = Topology.mixed(
        [CATALOG["s25"]] * 4,
        [dataclasses.replace(topo.resources["v2v-0-1"],
                             members=frozenset((0, 1))),
         dataclasses.replace(topo.resources["v2v-2-3"],
                             members=frozenset((2, 3)))],
        {(0, 1): ["v2v-0-1"], (1, 0): ["v2v-0-1"],
         (2, 3): ["v2v-2-3"], (3, 2): ["v2v-2-3"]})
    with pytest.raises(ValueError, match="disconnect"):
        two_islands.subset([0, 1, 2, 3])


def test_churn_on_ring_scenario_replans():
    """End to end: a vehicle leaves the V2V ring and the session keeps
    serving on the rerouted 3-node fleet."""
    session = dora.serve("vehicle_platoon")
    new, action, _ = session.on_dynamics(DynamicsEvent(t=5.0, leave=(2,)))
    assert action == "replan"
    assert session.active == (0, 1, 3)
    assert math.isfinite(new.latency) and new.latency > 0.0


# -- regression: cumulative dynamics state --------------------------------------
def test_successive_partial_events_compound():
    """A bandwidth drop at t=10 must still be in force when a
    compute-speed event arrives at t=20 (pre-fix, only the newest
    event's dicts reached the scheduler)."""
    sc = tiny_scenario()
    session = dora.serve(sc)
    best = session.current
    sched = session.adapter.scheduler
    session.on_dynamics(DynamicsEvent(t=10.0, bandwidth_scale={"wifi": 0.5}),
                        replan=False)
    session.on_dynamics(DynamicsEvent(t=20.0, compute_speed={0: 0.9}),
                        replan=False)
    merged = sched.refine(best, compute_speed={0: 0.9},
                          bandwidth_scale={"wifi": 0.5}).latency
    newest_only = sched.refine(best, compute_speed={0: 0.9}).latency
    assert merged > newest_only + 1e-9          # the premise: bw drop matters
    assert session.current.latency == pytest.approx(merged, abs=1e-12)
    assert session.state.bandwidth_scale == {"wifi": 0.5}
    assert session.state.compute_speed == {0: 0.9}


def test_runtime_state_delta_is_relative_to_accumulated():
    state = RuntimeState(bandwidth_scale={"wifi": 0.4})
    # restating the same degraded value is NOT a new shift...
    assert state.delta(DynamicsEvent(t=1.0, bandwidth_scale={"wifi": 0.4})) \
        == pytest.approx(0.0)
    # ...but restoring to nominal is a 0.6 shift
    assert state.delta(DynamicsEvent(t=1.0, bandwidth_scale={"wifi": 1.0})) \
        == pytest.approx(0.6)
    assert state.delta(DynamicsEvent(t=1.0, leave=(0,))) == math.inf


# -- regression: full QoE verdict ------------------------------------------------
def _plan(lat, per_dev_energy, per_dev_mem=None):
    st = Stage(node_ids=[0], devices=[0], microbatch_split={0: 1.0},
               fwd_time=lat, param_bytes=1e6)
    return ParallelismPlan(stages=[st], microbatch_size=1, n_microbatches=1,
                           latency=lat, energy=sum(per_dev_energy.values()),
                           per_device_energy=dict(per_dev_energy),
                           per_device_memory=dict(per_dev_mem or {}))


def test_qoe_satisfied_enforces_energy_budget():
    qoe = QoESpec(t_qoe=1.0, e_qoe=10.0)
    assert qoe.satisfied(_plan(0.5, {0: 9.0}))
    assert not qoe.satisfied(_plan(0.5, {0: 11.0}))     # fast but over budget
    assert not qoe.satisfied(_plan(2.0, {0: 9.0}))      # cheap but slow
    assert QoESpec(t_qoe=1.0).satisfied(_plan(0.5, {0: 1e9}))  # no budget set


def test_qoe_satisfied_enforces_memory_cap():
    qoe = QoESpec(t_qoe=1.0, m_qoe=100.0)
    assert qoe.satisfied(_plan(0.5, {0: 1.0}, {0: 99.0}))
    assert not qoe.satisfied(_plan(0.5, {0: 1.0}, {0: 101.0}))


def test_session_meets_qoe_sees_energy_budget():
    """Pre-fix, ServeSession.meets_qoe ignored e_qoe entirely."""
    sc = tiny_scenario(e_qoe=1e-9)          # impossible per-device budget
    session = dora.serve(sc)
    assert session.current.latency <= sc.qoe.t_qoe   # latency alone is fine
    assert not session.meets_qoe
    trace = dora.simulate(
        sc, session=session,
        events=[DynamicsEvent(t=1.0, compute_speed={0: 0.99})])
    assert not trace.steps[-1].qoe_ok


# -- regression: switch-cost-aware replanning ------------------------------------
def test_replan_keeps_current_when_switch_cost_dominates():
    """With a huge drain stall, migrating for a marginal gain is a net
    loss: the adapter must keep the (rescheduled) current plan and
    charge no stall.  Pre-fix it always switched and always charged."""
    sc = tiny_scenario()
    session = dora.serve(sc)
    candidates = list(session.report.candidates)
    adapter = RuntimeAdapter(candidates, session.report.topology,
                             session.report.qoe, session.adapter.scheduler,
                             AdapterConfig(switch_drain_s=1e4))
    current = session.current
    new, action, _ = adapter.on_dynamics(
        current, DynamicsEvent(t=1.0, compute_speed={0: 0.5}),
        replan_fn=lambda: candidates)
    assert action == "replan"
    assert new.meta["switch_stall_s"] == 0.0
    assert [s.node_ids for s in new.stages] == \
        [s.node_ids for s in current.stages]
    assert [s.devices for s in new.stages] == \
        [s.devices for s in current.stages]


def test_replan_still_switches_when_stall_is_free():
    """Zero switch cost: the adapter picks the best refined candidate
    (never worse than keeping current)."""
    sc = tiny_scenario()
    session = dora.serve(sc)
    candidates = list(session.report.candidates)
    cfg = AdapterConfig(switch_drain_s=0.0)
    adapter = RuntimeAdapter(candidates, session.report.topology,
                             session.report.qoe, session.adapter.scheduler,
                             cfg)
    worst = max(candidates, key=lambda p: p.objective)
    ev = DynamicsEvent(t=1.0, compute_speed={0: 0.5})
    new, action, _ = adapter.on_dynamics(worst, ev,
                                         replan_fn=lambda: candidates)
    sched = adapter.scheduler
    refined_best = min(
        (sched.refine(p, compute_speed={0: 0.5}) for p in candidates),
        key=lambda p: p.objective)
    assert action == "replan"
    assert new.objective <= refined_best.objective + 1e-9


# -- catalog breadth -------------------------------------------------------------
def test_catalog_scenarios_declare_request_rates():
    from repro_torch.scenarios import iter_scenarios
    for sc in iter_scenarios():
        assert sc.request_rate is not None and sc.request_rate > 0.0, sc.name


@pytest.mark.parametrize("name", ["traffic_monitor", "hospital_ward"])
def test_catalog_scenario_requests_mode(name):
    """mode='requests' end to end on real catalog scenarios, default
    timeline included (traffic_monitor's carries leave/join churn)."""
    trace = dora.simulate(name, mode="requests",
                          load=ServingLoad(rate=3.0, n_requests=40, seed=1))
    assert isinstance(trace, ServingTrace)
    assert len(trace.requests) == 40
    assert trace.p99 >= trace.p50 > 0.0
    assert trace.energy > 0.0
    if name == "traffic_monitor":
        assert trace.replans == 2               # leave + rejoin


# -- regression: bottleneck-stage admission interval ------------------------------
def test_service_interval_uses_bottleneck_stage():
    """A pipeline's steady-state throughput is bounded by its slowest
    stage, not the average: with exec spans 0.9/0.1 s the admission
    interval must be 0.9 s (pre-fix: latency/n_stages = 0.5 s, which
    oversubscribes the bottleneck device 1.8x)."""
    from repro_torch.core.engine import ScheduleResult
    from repro_torch.core.events import service_interval as _service_interval

    def mk(training=False, sched=None, lat=1.0, n=2):
        stages = [Stage(node_ids=[i], devices=[i], microbatch_split={i: 1.0})
                  for i in range(n)]
        p = ParallelismPlan(stages=stages, microbatch_size=1,
                            n_microbatches=1, training=training, latency=lat)
        p.schedule = sched
        return p

    unbalanced = ScheduleResult(makespan=1.0, start={}, finish={},
                                resource_busy={},
                                device_busy={"exec0": 0.9, "exec1": 0.1})
    assert _service_interval(mk(sched=unbalanced)) == pytest.approx(0.9)
    # unrefined plans keep the balanced-pipeline approximation
    assert _service_interval(mk()) == pytest.approx(0.5)
    # training serializes on the flush regardless of stage balance
    assert _service_interval(mk(training=True, sched=unbalanced)) \
        == pytest.approx(1.0)
    # a saturated network resource bounds admission too
    comm_bound = ScheduleResult(makespan=1.0, start={}, finish={},
                                resource_busy={"wifi": 0.8},
                                device_busy={"exec0": 0.2, "exec1": 0.2})
    assert _service_interval(mk(sched=comm_bound)) == pytest.approx(0.8)


def test_refined_plans_never_admit_past_device_capacity():
    """With bottleneck admission, booked compute-seconds per device can
    never exceed the horizon even at saturating arrival rates (pre-fix
    the per-stage average admitted too fast and oversubscribed)."""
    sc = tiny_scenario()
    trace = simulate_requests(
        sc, load=ServingLoad(rate=50.0, n_requests=200, seed=3), events=())
    assert all(trace.utilization(d) <= 1.0 + 1e-6
               for d in trace.per_device_busy)
    assert trace.oversubscribed_devices == []


# -- regression: utilization clamp hid oversubscription ---------------------------
def test_utilization_reports_raw_ratio_and_oversubscription():
    """Pre-fix, busy/horizon was silently clamped to 1.0, hiding
    oversubscription from the multi-tenant path."""
    from repro_torch.sim.serving import RequestRecord
    trace = ServingTrace(scenario="x", strategy="dora",
                         load=ServingLoad(rate=1.0, n_requests=1),
                         slo_s=1.0,
                         requests=[RequestRecord(0.0, 0.0, 0.5)],
                         actions=[],
                         per_device_energy={0: 1.0, 1: 1.0},
                         per_device_busy={0: 15.0, 1: 5.0}, horizon_s=10.0)
    assert trace.utilization(0) == pytest.approx(1.5)    # raw, not 1.0
    assert trace.utilization(1) == pytest.approx(0.5)
    assert trace.oversubscribed(0)
    assert not trace.oversubscribed(1)
    assert trace.oversubscribed_devices == [0]
    assert trace.to_dict()["oversubscribed_devices"] == [0]
