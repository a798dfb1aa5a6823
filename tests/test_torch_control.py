# Mirror of tests/test_control.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""The real-time control plane (``repro_torch.control``).

Covers the three within-plan mechanisms behind
:class:`~repro_torch.control.ControlConfig` — stage-level priority
preemption, battery state of charge, DEFER-style streamed migration —
plus the unification invariants the refactor locks:

* every mechanism off is bit-identical to the historical path,
* results stay invariant to the kernel's chunk width *through* the
  new mechanisms (preemption bumps, SoC churn, streamed stalls),
* ``ServeSession`` / ``FleetSession`` / the ladder are thin adapters
  over exactly one reaction implementation,
* moved internals stay importable behind ``DeprecationWarning`` shims.
"""
from __future__ import annotations

import dataclasses
import inspect
import types
import warnings

import numpy as np
import pytest

import repro_torch.dora as dora
from repro_torch.control import BatteryTracker, ControlConfig
from repro_torch.core.adapter import DynamicsEvent
from repro_torch.core.device import Topology
from repro_torch.core.events import (ActivePlan, RequestClass, ServingLoad, Stream,
                               interactive_batch, preemption_spec)
from repro_torch.sim.serving import simulate_requests


def _assert_close_traces(a, b, what: str) -> None:
    """Same comparison contract as the kernel segmentation tests:
    float accumulation order may differ across chunk widths, so traces
    match to 1e-9, with infinities (failed requests) aligned exactly."""
    fa, fb = a.requests.finish, b.requests.finish
    assert np.array_equal(a.requests.arrival, b.requests.arrival), what
    assert np.array_equal(np.isinf(fa), np.isinf(fb)), what
    assert np.allclose(fa[np.isfinite(fa)], fb[np.isfinite(fb)],
                       rtol=1e-9, atol=1e-9), what


# -- mechanism 1: stage-level priority preemption ------------------------------
def _plan(latency=1.0, interval=0.5):
    return ActivePlan(latency=latency, interval=interval,
                      per_device_energy={0: 2.0}, non_idle_energy={0: 1.5},
                      compute_busy={0: 0.25}, devices=(0,))


def test_preemption_spec_none_without_priority_classes():
    ids = np.zeros(8, dtype=np.int64)
    assert preemption_spec((), None, 0.005) is None
    flat = (RequestClass("a"), RequestClass("b"))
    assert preemption_spec(flat, ids, 0.005) is None
    tiered = interactive_batch(0.05, 10.0, interactive_share=0.5)
    spec = preemption_spec(tiered, ids, 0.005)
    assert spec is not None and spec.overhead_s == 0.005


def test_zero_interactive_trace_stays_on_fifo_path():
    """A spec whose sampled trace carries no interactive request at all
    must keep the exact vectorized FIFO path (bit-identity, not just
    closeness)."""
    rng = np.random.default_rng(7)
    arr = np.cumsum(rng.exponential(0.3, size=300))
    tiered = interactive_batch(0.05, 10.0, interactive_share=0.5)
    batch_only = np.full(len(arr), 1, dtype=np.int64)   # class 1 == batch
    spec = preemption_spec(tiered, batch_only, 0.005)
    armed = Stream(arr, plan=_plan(), preempt=spec)
    assert armed.preempt is None                         # decided once
    plain = Stream(arr, plan=_plan())
    armed.drain()
    plain.drain()
    assert np.array_equal(armed.arrays()[2], plain.arrays()[2])
    assert np.array_equal(armed.arrays()[1], plain.arrays()[1])


def test_interactive_never_queues_behind_batch():
    """Property (a): interactive admissions follow a pure Lindley
    recurrence over *interactive arrivals alone* — queued batch work is
    invisible to them, whatever the interleaving."""
    rng = np.random.default_rng(11)
    arr = np.cumsum(rng.exponential(0.2, size=400))
    tiered = interactive_batch(0.05, 10.0, interactive_share=0.4)
    ids = rng.integers(0, 2, size=len(arr))
    spec = preemption_spec(tiered, ids, 0.005)
    s = Stream(arr, plan=_plan(latency=1.0, interval=0.5), preempt=spec)
    s.drain()
    _, starts, finishes = s.arrays()
    hot = np.isin(ids, list(spec.interactive))
    frontier = 0.0
    for a, st, fin in zip(arr[hot], starts[hot], finishes[hot]):
        expect = max(float(a), frontier)
        assert st == pytest.approx(expect, abs=1e-9)
        assert fin == pytest.approx(expect + 1.0, abs=1e-9)
        frontier = expect + 0.5


def test_preemption_charges_batch_for_displacement():
    """A batch admission whose occupancy a later interactive request
    displaces pays the interactive interval plus the resume overhead."""
    arr = np.asarray([0.0, 0.1])
    tiered = interactive_batch(0.05, 10.0, interactive_share=0.5)
    ids = np.asarray([1, 0])            # batch first, interactive preempts
    spec = preemption_spec(tiered, ids, overhead_s=0.25)
    s = Stream(arr, plan=_plan(latency=1.0, interval=0.5), preempt=spec)
    s.drain()
    _, starts, finishes = s.arrays()
    assert starts[1] == pytest.approx(0.1)              # jumps the queue
    assert finishes[1] == pytest.approx(1.1)
    # batch: served at 0.0, but its occupancy [0, 0.5) is pierced by the
    # interactive window [0.1, 0.6): + interval + overhead
    assert finishes[0] == pytest.approx(1.0 + 0.5 + 0.25)


def test_preemption_improves_interactive_tail_not_aggregate():
    load = ServingLoad(rate=6.0, n_requests=400, seed=3,
                       classes=interactive_batch(0.5, 10.0,
                                                 interactive_share=0.3))
    fifo = simulate_requests("hospital_ward", load=load)
    pre = simulate_requests("hospital_ward", load=load,
                            control=ControlConfig(preemption=True))
    cf, cp = fifo.class_metrics(), pre.class_metrics()
    assert cp["interactive"]["p95"] < cf["interactive"]["p95"]
    assert (cp["interactive"]["slo_attainment"]
            >= cf["interactive"]["slo_attainment"])
    assert pre.slo_attainment >= fifo.slo_attainment
    # the same requests were served: per-device busy time is identical
    assert pre.per_device_busy == fifo.per_device_busy


@pytest.mark.parametrize("chunk", [7, 64, None])
def test_preemption_chunk_invariance(chunk):
    """Property (c): results are invariant to the kernel's vectorization
    width through preemption bumps."""
    load = ServingLoad(rate=6.0, n_requests=300, seed=3,
                       classes=interactive_batch(0.5, 10.0,
                                                 interactive_share=0.3))
    cc = ControlConfig(preemption=True)
    ref = simulate_requests("hospital_ward", load=load, chunk=1, control=cc)
    got = simulate_requests("hospital_ward", load=load, chunk=chunk,
                            control=cc)
    _assert_close_traces(got, ref, f"preemption chunk={chunk}")


def test_control_all_off_is_bit_identical():
    """Property (b): an all-defaults ControlConfig is the historical
    path, bit for bit."""
    load = ServingLoad(rate=5.0, n_requests=200, seed=2)
    plain = simulate_requests("hospital_ward", load=load)
    off = simulate_requests("hospital_ward", load=load,
                            control=ControlConfig())
    assert np.array_equal(plain.requests.finish, off.requests.finish)
    assert plain.slo_attainment == off.slo_attainment
    assert plain.per_device_energy == off.per_device_energy


# -- mechanism 2: battery state of charge --------------------------------------
def _dev(battery_j=None, p_idle=2.0):
    return types.SimpleNamespace(battery_j=battery_j, p_idle=p_idle)


def test_battery_tracker_integrates_idle_and_service_drain():
    tr = BatteryTracker([_dev(), _dev(battery_j=100.0, p_idle=2.0)])
    assert set(tr.capacity) == {1}          # wall-powered dev 0 untracked
    assert tr.advance(5.0, {1: 10.0}, present={0, 1}) == []
    assert tr.drained[1] == pytest.approx(2.0 * 5.0 + 10.0)
    assert tr.remaining(1) == pytest.approx(80.0)
    assert tr.soc(1) == pytest.approx(0.8)
    # absent devices stop draining idle but still absorb service deltas
    tr.advance(10.0, {1: 12.0}, present=set())
    assert tr.drained[1] == pytest.approx(22.0)


def test_battery_tracker_death_and_projection():
    tr = BatteryTracker([_dev(battery_j=50.0, p_idle=5.0)])
    assert tr.advance(4.0, {}, present={0}) == []       # 20 J drained
    ttd = tr.time_to_death(0)
    assert ttd == pytest.approx(30.0 / 5.0)
    assert tr.advance(10.0, {}, present={0}) == [0]     # 50 J >= capacity
    assert tr.time_to_death(0) == 0.0
    assert 0 in tr.dead
    # dead devices never drain further or die twice
    assert tr.advance(20.0, {}, present={0}) == []


def test_battery_tracker_rate_is_smoothed():
    """Bursty service energy must not make the projection flap: the
    rate estimate is an EMA of the per-interval observations."""
    tr = BatteryTracker([_dev(battery_j=1000.0, p_idle=0.0)])
    tr.advance(1.0, {0: 10.0}, present={0})             # 10 J/s
    tr.advance(2.0, {0: 10.0}, present={0})             # 0 J/s interval
    assert tr._rate[0] == pytest.approx(5.0)            # not 0: smoothed
    assert tr.time_to_death(0) == pytest.approx(990.0 / 5.0)


def test_battery_requires_the_dora_strategy():
    with pytest.raises(ValueError, match="battery"):
        simulate_requests("hospital_ward", strategy="chain_split",
                          load=ServingLoad(rate=2.0, n_requests=20, seed=0),
                          control=ControlConfig(battery=True))


@pytest.fixture(scope="module")
def ward_battery():
    """hospital_ward with the hottest device given a battery sized to
    die mid-horizon (self-calibrated from a dry run)."""
    load = ServingLoad(rate=5.0, n_requests=200, seed=2)
    dry = simulate_requests("hospital_ward", load=load)
    pe = dry.per_device_energy
    hot = max(pe, key=pe.get)
    topo = dora.serve("hospital_ward").report.topology
    devs = list(topo.devices)
    devs[hot] = dataclasses.replace(devs[hot], battery_j=0.5 * pe[hot])
    topo2 = Topology(devs, list(topo.resources.values()), topo._p2p)
    return load, topo2, hot


def _dead_battery_violations(tr) -> int:
    """SLO misses among requests arriving at/after the first battery
    death (the QoE damage the aware arm exists to avoid)."""
    deaths = [a.t for a in tr.actions if a.label.startswith("battery dead")]
    if not deaths:
        return 0
    arr, fin = tr.requests.arrival, tr.requests.finish
    late = arr >= min(deaths)
    return int(np.count_nonzero(late & ((fin - arr) > tr.slo_s)))


def test_battery_death_forces_a_synchronous_replan(ward_battery):
    load, topo2, hot = ward_battery
    tr = simulate_requests("hospital_ward", load=load, topology=topo2,
                           control=ControlConfig(battery=True))
    dead = [a for a in tr.actions if a.label == f"battery dead: device {hot}"]
    assert len(dead) == 1
    assert dead[0].action == "replan" and dead[0].stall_s > 0.0
    assert _dead_battery_violations(tr) > 0
    # the fleet kept serving on the survivors after the death
    assert np.isfinite(tr.requests.finish[-1])


def test_battery_aware_evacuates_before_death(ward_battery):
    load, topo2, hot = ward_battery
    tr = simulate_requests("hospital_ward", load=load, topology=topo2,
                           control=ControlConfig(battery=True,
                                                 battery_aware=True))
    labels = [a.label for a in tr.actions]
    assert not any(lbl.startswith("battery dead") for lbl in labels)
    assert any(lbl.startswith(f"battery low: evacuating device {hot}")
               for lbl in labels)
    assert _dead_battery_violations(tr) == 0


@pytest.mark.parametrize("chunk", [7, 64, None])
def test_battery_chunk_invariance(chunk, ward_battery):
    """Property (c): invariance holds through SoC churn too."""
    load, topo2, _ = ward_battery
    cc = ControlConfig(battery=True, battery_aware=True)
    ref = simulate_requests("hospital_ward", load=load, topology=topo2,
                            chunk=1, control=cc)
    got = simulate_requests("hospital_ward", load=load, topology=topo2,
                            chunk=chunk, control=cc)
    _assert_close_traces(got, ref, f"battery chunk={chunk}")


def test_battery_ignored_without_battery_devices():
    """No battery_j anywhere: the tracker disarms and the trace is the
    plain one (no SoC checkpoints, no actions)."""
    load = ServingLoad(rate=5.0, n_requests=100, seed=2)
    plain = simulate_requests("hospital_ward", load=load)
    armed = simulate_requests("hospital_ward", load=load,
                              control=ControlConfig(battery=True))
    assert np.array_equal(plain.requests.finish, armed.requests.finish)
    assert not armed.actions


# -- mechanism 3: DEFER-style streamed migration -------------------------------
@pytest.fixture(scope="module")
def ward_switch():
    """A synchronous-switch session plus a multi-device target plan
    (nonzero weight-load time)."""
    s = dora.serve("hospital_ward")
    cfg = s.adapter.config
    cfg.async_switching = False
    cfg.delta_switching = False
    old = s.current
    new = next(p for p in s.plans if len(p.devices) > 1)
    return s, old, new


def test_streamed_switch_zero_overlap_equals_sync(ward_switch):
    s, old, new = ward_switch
    s.adapter.config.streamed_migration = False
    sync = s.adapter.switch_cost(old, new)
    assert sync > s.adapter.config.switch_drain_s       # real load time
    s.adapter.config.streamed_migration = True
    assert s.adapter.switch_cost(old, new, overlap_s=0.0) \
        == pytest.approx(sync)


def test_streamed_switch_stall_monotone_in_overlap(ward_switch):
    s, old, new = ward_switch
    s.adapter.config.streamed_migration = True
    overlaps = [0.0, 1.0, 5.0, 20.0, 1e9]
    costs = [s.adapter.switch_cost(old, new, overlap_s=o) for o in overlaps]
    assert all(a >= b for a, b in zip(costs, costs[1:]))
    # fully overlapped: only the drain is exposed
    assert costs[-1] == pytest.approx(s.adapter.config.switch_drain_s)
    # default overlap is one iteration of the outgoing plan
    assert s.adapter.switch_cost(old, new) \
        == pytest.approx(s.adapter.switch_cost(old, new,
                                               overlap_s=old.latency))


def test_streamed_migration_reduces_priced_stall_end_to_end():
    load = ServingLoad(rate=4.0, n_requests=150, seed=2)
    events = [("leave", DynamicsEvent(t=8.0, leave=(1,)))]
    stalls = {}
    for streamed in (False, True):
        cc = ControlConfig(streamed_migration=True) if streamed else None
        s = dora.serve("smart_home_1", control=cc)
        s.adapter.config.async_switching = False
        tr = simulate_requests("smart_home_1", load=load, session=s,
                               events=events)
        (act,) = [a for a in tr.actions if a.action == "replan"]
        stalls[streamed] = act.stall_s
    assert stalls[True] < stalls[False]


@pytest.mark.parametrize("chunk", [7, 64, None])
def test_streamed_migration_chunk_invariance(chunk):
    """Property (c): invariance holds through streamed-stall segments."""
    load = ServingLoad(rate=4.0, n_requests=120, seed=2)
    events = [("leave", DynamicsEvent(t=8.0, leave=(1,)))]

    def run(c):
        s = dora.serve("smart_home_1",
                       control=ControlConfig(streamed_migration=True))
        s.adapter.config.async_switching = False
        return simulate_requests("smart_home_1", load=load, session=s,
                                 events=events, chunk=c)
    _assert_close_traces(run(chunk), run(1), f"streamed chunk={chunk}")


# -- the unified reaction layer ------------------------------------------------
def test_fleet_tenant_state_retains_bandwidth_through_rebalance():
    """Regression: a re-armed tenant used to drop accumulated bandwidth
    shifts for links outside its *current* sub-topology, diverging from
    the fleet's cumulative RuntimeState — and mispricing the link if a
    later rebalance handed it back."""
    session = dora.serve_fleet("traffic_intersection")
    session.on_dynamics(DynamicsEvent(t=10.0,
                                      bandwidth_scale={"ring-2-3": 0.5}))
    session.on_dynamics(DynamicsEvent(t=20.0, leave=(3,)))
    assert session.state.bandwidth_scale == {"ring-2-3": 0.5}
    tracker = session.sessions["tracker"]
    assert tracker.state.bandwidth_scale.get("ring-2-3") == 0.5
    # the retained shift survives regaining the link
    session.on_dynamics(DynamicsEvent(t=30.0, join=(3,)))
    assert session.sessions["tracker"].state \
        .bandwidth_scale.get("ring-2-3") == 0.5


def test_sessions_are_thin_adapters_over_the_plane():
    """Exactly one reaction implementation: the session entry points
    delegate to ``repro_torch.control`` instead of reacting themselves."""
    from repro_torch.dora import ServeSession
    from repro_torch.fleet.session import FleetSession
    from repro_torch.resilience.ladder import FallbackLadder, FleetLadder
    for fn in (ServeSession.on_dynamics, FleetSession.on_dynamics,
               FleetSession._rebalance, FallbackLadder.apply,
               FleetLadder.apply):
        src = inspect.getsource(fn)
        assert "self.plane." in src or "self.session.plane." in src, fn


def test_serve_threads_control_config_through():
    cc = ControlConfig(preemption=True, streamed_migration=True,
                       stream_bw_fraction=0.25)
    s = dora.serve("hospital_ward", control=cc)
    assert s.control is cc
    assert s.plane.config is cc
    assert s.adapter.config.streamed_migration
    assert s.adapter.config.stream_bw_fraction == 0.25


# -- deprecation shims ---------------------------------------------------------
@pytest.mark.parametrize("module,name,target", [
    ("repro_torch.sim.serving", "poisson_arrivals", "poisson_arrivals"),
    ("repro_torch.sim.serving", "_ActivePlan", "ActivePlan"),
    ("repro_torch.sim.serving", "_freeze", "freeze_plan"),
    ("repro_torch.sim.serving", "_service_interval", "service_interval"),
    ("repro_torch.dora", "_remap_plan", "_remap_plan"),
])
def test_moved_internals_warn_but_resolve(module, name, target):
    import importlib

    from repro_torch.core import events as kernel
    mod = importlib.import_module(module)
    with pytest.warns(DeprecationWarning, match=name):
        got = getattr(mod, name)
    if module == "repro_torch.dora":
        from repro_torch.control import plane
        assert got is getattr(plane, target)
    else:
        assert got is getattr(kernel, target)


def test_fresh_session_emits_no_deprecation_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        s = dora.serve("hospital_ward")
        simulate_requests("hospital_ward", session=s,
                          load=ServingLoad(rate=4.0, n_requests=50, seed=1))
