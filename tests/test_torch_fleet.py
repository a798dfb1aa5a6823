# Mirror of tests/test_fleet.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Multi-tenant fleet layer: co-planning, rebalancing, serving, and the
Topology subsetting contract tenant allotments rely on."""
import json

import pytest

from repro_torch import dora
from repro_torch.core.adapter import DynamicsEvent
from repro_torch.core.cost_model import PAPER_SERVE_WORKLOAD
from repro_torch.core.device import CATALOG, Topology, make_setting
from repro_torch.core.planner import DoraPlanner
from repro_torch.core.qoe import QoESpec
from repro_torch.fleet import (FleetPlanner, FleetScenario, list_fleets,
                         plan_independent, resolve_fleet)
from repro_torch.scenarios import Scenario
from repro_torch.sim.fleet import FleetTrace, simulate_fleet
from repro_torch.sim.serving import ServingLoad


def _home2():
    return make_setting("smart_home_2")


def _tenant(name, model, t_qoe, rate):
    return Scenario(name=name, description="test tenant", topology=_home2,
                    model=model, workload=PAPER_SERVE_WORKLOAD,
                    qoe=QoESpec(t_qoe=t_qoe, lam=100.0), request_rate=rate)


@pytest.fixture(scope="module")
def assist_session():
    """One armed smart_home_assist session shared by read-only tests."""
    return dora.serve_fleet("smart_home_assist")


# -- Topology: disjoint tenant allotments (the device-exclusive contract) --------
def test_subset_disjoint_allotments_are_independent():
    """Two disjoint keep-sets of one fleet calibrate and plan completely
    independently: same devices, same plans as planning each allotment
    as if the other tenant did not exist."""
    topo = _home2()
    sub_a, map_a = topo.subset([0, 1])
    sub_b, map_b = topo.subset([2, 3, 4])
    assert [d.name for d in sub_a.devices] \
        == [topo.devices[i].name for i in (0, 1)]
    assert [d.name for d in sub_b.devices] \
        == [topo.devices[i].name for i in (2, 3, 4)]
    sc = _tenant("t", "qwen3-0.6b", 0.3, 1.0)
    graph = sc.build_graph()
    plan_a = DoraPlanner(graph, sub_a, sc.qoe).plan(sc.workload).best
    plan_b = DoraPlanner(graph, sub_b, sc.qoe).plan(sc.workload).best
    # re-planning A after B (any order) yields the identical plan
    plan_a2 = DoraPlanner(graph, topo.subset([0, 1])[0],
                          sc.qoe).plan(sc.workload).best
    assert plan_a.latency == pytest.approx(plan_a2.latency, abs=0.0)
    assert plan_a.energy == pytest.approx(plan_a2.energy, abs=0.0)
    assert {d for s in plan_a.stages for d in s.devices} <= {0, 1}
    assert {d for s in plan_b.stages for d in s.devices} <= {0, 1, 2}


def test_subset_routes_never_traverse_other_tenants_devices():
    """On a ring fleet split between two tenants, every surviving route
    of one tenant's subset runs only over links whose members are that
    tenant's own devices — never through the other tenant's exclusive
    hardware."""
    topo = Topology.ring([CATALOG["genio520"]] * 6, 100.0, name="ring")
    for keep in ([0, 1, 2], [3, 4, 5], [0, 1, 5]):
        sub, mapping = topo.subset(keep)
        own = set(range(len(keep)))
        for i in own:
            for j in own:
                if i == j:
                    continue
                for r in sub.resources_between(i, j):
                    assert r.members <= own, (keep, i, j, r.name)


def test_subset_of_subset_round_trips_device_ids():
    """Re-subsetting a subset composes the mappings back to the
    original fleet's device ids."""
    topo = _home2()
    sub1, m1 = topo.subset([0, 2, 3, 4])          # drop device 1
    inv1 = {new: old for old, new in m1.items()}
    sub2, m2 = sub1.subset([m1[2], m1[4]])        # keep originals {2, 4}
    inv2 = {new: old for old, new in m2.items()}
    originals = [inv1[inv2[i]] for i in range(sub2.n)]
    assert originals == [2, 4]
    assert [d.name for d in sub2.devices] \
        == [topo.devices[i].name for i in (2, 4)]
    # and a direct subset of the originals is identical
    direct, _ = topo.subset([2, 4])
    assert [d.name for d in direct.devices] \
        == [d.name for d in sub2.devices]
    assert set(direct.resources) == set(sub2.resources)


def test_subset_single_device_fleet():
    """A one-device allotment is legal on every fabric the generator
    emits: no links survive (or only the shared medium's remnant), and
    the device keeps its identity."""
    devs = [CATALOG["genio520"]] * 4
    for topo in (Topology.shared_medium(devs, 300.0),
                 Topology.star(devs, 300.0),
                 Topology.ring(devs, 300.0),
                 Topology.mesh(devs, 300.0)):
        for keep in range(topo.n):
            sub, mapping = topo.subset([keep])
            assert sub.n == 1
            assert mapping == {keep: 0}
            assert sub.devices[0].name == topo.devices[keep].name
            assert sub.resources_between(0, 0) == []


def test_subset_leave_then_join_same_device_twice():
    """Churning the same device out and back twice round-trips exactly:
    the rejoined fleet has the original's devices, resources and
    routes (the adapter replays join as a fresh subset of the full
    fleet)."""
    topo = Topology.ring([CATALOG["genio520"]] * 5, 200.0, name="ring")
    full = list(range(topo.n))
    for _ in range(2):                         # leave #3, rejoin, repeat
        sub, _ = topo.subset([i for i in full if i != 3])
        assert sub.n == topo.n - 1
        back, mapping = topo.subset(full)
        assert back.n == topo.n
        assert mapping == {i: i for i in full}
        assert set(back.resources) == set(topo.resources)
        assert [d.name for d in back.devices] \
            == [d.name for d in topo.devices]
        for i, j in ((0, 3), (3, 4), (1, 2)):
            assert back.peak_bandwidth(i, j) \
                == pytest.approx(topo.peak_bandwidth(i, j))


def test_subset_mesh_disconnection_raises():
    """Subsetting a partial mesh across a cut vertex raises the
    documented disconnection ValueError instead of silently planning
    over a fragment (only ring rerouting was covered before)."""
    devs = [CATALOG["genio520"]] * 5
    # 0-1-2 and 3-4 joined only through 2: dropping 2 cuts the mesh
    topo = Topology.mesh(devs, 150.0,
                         edges=[(0, 1), (1, 2), (2, 3), (3, 4)])
    with pytest.raises(ValueError, match="disconnect"):
        topo.subset([0, 1, 3, 4])
    # either side of the cut on its own is fine
    left, _ = topo.subset([0, 1, 2])
    right, _ = topo.subset([3, 4])
    assert left.n == 3 and right.n == 2
    assert left.resources_between(0, 2)
    # line interiors cut the same way
    line = Topology.line(devs, 150.0)
    with pytest.raises(ValueError, match="disconnect"):
        line.subset([0, 1, 4])


def test_scale_resources_prices_shared_links():
    topo = _home2()
    half = topo.scale_resources({"wifi": 0.5})
    assert half.resources["wifi"].capacity \
        == pytest.approx(topo.resources["wifi"].capacity / 2.0)
    assert half.n == topo.n
    assert half.peak_bandwidth(0, 1) \
        == pytest.approx(topo.peak_bandwidth(0, 1) / 2.0)
    with pytest.raises(KeyError):
        topo.scale_resources({"nope": 0.5})


# -- FleetPlanner -----------------------------------------------------------------
def test_plan_fleet_assignments_are_exclusive_and_exhaustive():
    fp = dora.plan_fleet("smart_home_assist")
    allots = list(fp.assignments.values())
    union = [d for a in allots for d in a]
    assert sorted(union) == list(range(fp.topology.n))   # full partition
    assert len(union) == len(set(union))                 # exclusive
    assert fp.feasible
    for name, tp in fp.tenants.items():
        assert tp.report.topology.n == len(tp.allotment)
        placed = {tp.allotment[d] for d in tp.plan.devices}
        assert placed <= set(tp.allotment)


def test_plan_fleet_beats_independent_planning():
    """The acceptance claim: co-planning keeps every tenant
    QoE-feasible where independent full-fleet planning (priced under
    fluid-fair interference) violates a tenant's QoE or spends more
    energy."""
    for name in ("smart_home_assist", "traffic_intersection"):
        fs = resolve_fleet(name)
        co = dora.plan_fleet(name)
        ind = plan_independent(fs.build_topology(), fs.tenants,
                               name=fs.name)
        assert co.feasible, name
        assert (not ind.feasible
                or ind.total_energy > 1.05 * co.total_energy), name
        assert not ind.exclusive
        # the baseline's whole point: tenants overlap on some device
        seen = [set(t.allotment) for t in ind.tenants.values()]
        assert any(a & b for i, a in enumerate(seen)
                   for b in seen[i + 1:])


def test_shared_link_priced_at_fluid_fair_share():
    topo = _home2()
    planner = FleetPlanner(topo, [_tenant("a", "bert", 0.5, 1.0),
                                  _tenant("b", "bert", 0.5, 1.0)])
    shares = planner.link_shares([(0, 1), (2, 3, 4)])
    assert shares == {"wifi": 2}            # both tenants span the medium
    sub, _ = planner.tenant_topology((0, 1), shares)
    assert sub.resources["wifi"].capacity \
        == pytest.approx(topo.resources["wifi"].capacity / 2.0)
    # a single-device tenant never transfers: medium not shared with it
    assert planner.link_shares([(0,), (1, 2, 3, 4)]) == {"wifi": 1}
    sub_full, _ = planner.tenant_topology((1, 2, 3, 4),
                                          {"wifi": 1})
    assert sub_full.resources["wifi"].capacity \
        == pytest.approx(topo.resources["wifi"].capacity)


def test_plan_fleet_single_tenant_matches_solo_plan():
    sc = _tenant("solo", "qwen3-0.6b", 0.3, 1.0)
    fp = dora.plan_fleet([sc])
    solo = dora.plan(sc)
    assert fp.tenants["solo"].allotment == tuple(range(5))
    assert fp.tenants["solo"].latency == pytest.approx(solo.latency)
    assert fp.tenants["solo"].energy == pytest.approx(solo.energy)


def test_plan_fleet_errors():
    two_dev = Topology.shared_medium([CATALOG["s25"], CATALOG["mi15"]],
                                     300.0)
    tenants = [_tenant(f"t{i}", "bert", 1.0, 1.0) for i in range(3)]
    with pytest.raises(ValueError, match="exclusive device"):
        FleetPlanner(two_dev, tenants)
    with pytest.raises(ValueError, match="unique"):
        FleetPlanner(_home2(), [tenants[0], tenants[0]])
    with pytest.raises(KeyError, match="unknown fleet"):
        resolve_fleet("nope")
    with pytest.raises(ValueError, match="at least one tenant"):
        resolve_fleet([])


def test_fleet_catalog_registered():
    names = list_fleets()
    assert {"smart_home_assist", "traffic_intersection",
            "smart_home_overnight"} <= set(names)
    for name in names:
        fs = resolve_fleet(name)
        assert isinstance(fs, FleetScenario)
        assert len(fs.tenants) >= 2
        assert all(t.request_rate for t in fs.tenants)


# -- FleetSession: rebalancing ----------------------------------------------------
def test_churn_rebalances_devices_between_tenants():
    session = dora.serve_fleet("traffic_intersection")
    before = session.assignments
    acts = session.on_dynamics(DynamicsEvent(t=20.0, leave=(3,)))
    assert session.rebalances == 1
    assert acts and all(a.action == "rebalance" for a in acts)
    allots = list(session.assignments.values())
    union = sorted(d for a in allots for d in a)
    assert union == [0, 1, 2]               # full partition of survivors
    assert len(union) == len({d for a in allots for d in a})
    session.on_dynamics(DynamicsEvent(t=60.0, join=(3,)))
    union = sorted(d for a in session.assignments.values() for d in a)
    assert union == [0, 1, 2, 3]
    assert session.meets_qoe
    assert before.keys() == session.assignments.keys()


def test_load_shift_rebalance_recovers_qoe():
    """A thermal throttle that breaks one tenant's QoE must move the
    tenant onto healthy devices (condition-aware assignment search)."""
    session = dora.serve_fleet("traffic_intersection")
    victim = None
    for name, tp in session.plan.tenants.items():
        if name == "detector":
            victim = tp.allotment[tp.plan.devices[0]]
    assert victim in (0, 1)                 # detector needs a genio720
    session.on_dynamics(DynamicsEvent(t=10.0,
                                      compute_speed={victim: 0.6}))
    assert session.rebalances == 1
    det = session.plan.tenants["detector"]
    placed = {det.allotment[d] for d in session.sessions["detector"]
              .current.devices}
    assert victim not in placed             # moved off the hot device
    assert session.meets_qoe


def test_rebalance_requires_enough_devices():
    sc_a = _tenant("a", "bert", 1.0, 1.0)
    sc_b = _tenant("b", "bert", 1.0, 1.0)
    two_dev = Topology.shared_medium([CATALOG["rtx4050"],
                                      CATALOG["rtx4050"]], 600.0)
    session = dora.serve_fleet([sc_a, sc_b], topology=two_dev)
    with pytest.raises(ValueError, match="not enough devices"):
        session.on_dynamics(DynamicsEvent(t=1.0, leave=(1,)))
    with pytest.raises(ValueError, match="unknown devices"):
        session.on_dynamics(DynamicsEvent(t=1.0, leave=(9,)))


def test_condition_events_route_to_owning_tenant(assist_session):
    import copy as _copy
    session = _copy.deepcopy(assist_session)
    tp = session.plan.tenants["voice_assistant"]
    dev = tp.allotment[0]
    acts = session.on_dynamics(
        DynamicsEvent(t=1.0, compute_speed={dev: 0.95}))
    touched = {a.tenant for a in acts}
    assert "voice_assistant" in touched
    assert "vision_monitor" not in touched  # not its device
    # a shared-medium event reaches every tenant on the medium
    acts = session.on_dynamics(
        DynamicsEvent(t=2.0, bandwidth_scale={"wifi": 0.8}))
    assert {a.tenant for a in acts} \
        == {"voice_assistant", "vision_monitor"}


# -- multi-tenant serving simulation ----------------------------------------------
def test_simulate_fleet_end_to_end(assist_session):
    import copy as _copy
    trace = dora.simulate("smart_home_assist", mode="fleet",
                          session=_copy.deepcopy(assist_session))
    assert isinstance(trace, FleetTrace)
    assert set(trace.tenants) == {"voice_assistant", "vision_monitor"}
    for name, tr in trace.tenants.items():
        assert len(tr.requests) >= 8
        assert all(r.served for r in tr.requests)
        assert tr.p50 <= tr.p95 <= tr.p99
        assert tr.energy > 0.0
    assert trace.energy > 0.0
    assert trace.slo_attainment > 0.5
    json.dumps(trace.to_dict(), allow_nan=False)     # strict-JSON safe


def test_simulate_fleet_never_oversubscribes_exclusive_devices():
    """The fleet contract: exclusive devices can never be booked past
    wall clock, even at saturating per-tenant rates and through churn
    rebalances — summed across tenants AND per tenant."""
    loads = {"detector": ServingLoad(rate=20.0, n_requests=150, seed=1),
             "tracker": ServingLoad(rate=40.0, n_requests=300, seed=2)}
    trace = simulate_fleet("traffic_intersection", loads=loads)
    assert trace.oversubscribed_devices == []
    for tr in trace.tenants.values():
        assert tr.oversubscribed_devices == []
    assert all(trace.utilization(d) <= 1.0 + 1e-6
               for d in trace.per_device_busy)


def test_simulate_fleet_churn_timeline_rebalances():
    trace = simulate_fleet("traffic_intersection")
    assert trace.rebalances >= 2            # leave, throttle and/or join
    assert any(a.action == "rebalance" for a in trace.actions)
    assert all(r.served for tr in trace.tenants.values()
               for r in tr.requests)        # nobody went dark during churn
    union = sorted(d for a in trace.assignments.values() for d in a)
    assert union == list(range(4))          # fleet whole again at the end


def test_simulate_fleet_energy_attribution_consistent():
    """Per-tenant energies (service + idle of the tenant's final
    exclusive devices) must add up to the fleet-wide total when every
    device ends the run assigned."""
    trace = simulate_fleet("smart_home_assist",
                           loads={"voice_assistant":
                                  ServingLoad(rate=1.0, n_requests=20),
                                  "vision_monitor":
                                  ServingLoad(rate=2.0, n_requests=40)})
    tenant_total = sum(tr.energy for tr in trace.tenants.values())
    assert tenant_total == pytest.approx(trace.energy, rel=1e-9)
    owned = {d for a in trace.assignments.values() for d in a}
    assert owned == set(trace.per_device_energy)


def test_fleet_idle_prorated_by_ownership_through_rebalances():
    """Idle draw must follow the *ownership history* through mid-run
    rebalances, intersected with each device's presence interval.
    Historically every device's idle was billed to whichever tenant
    held it in the final assignment, over the full horizon — wrong as
    soon as a rebalance moved a device or a camera powered down."""
    trace = simulate_fleet("traffic_intersection", seed=5)
    horizon = trace.horizon_s
    assert trace.rebalances >= 2 and horizon > 80.0
    assert len(trace.ownership) >= 2          # initial snapshot + shuffles
    # the rebalancer really moved a device between tenants mid-run
    owner_of = [{d: n for n, devs in snap.items() for d in devs}
                for _, snap in trace.ownership]
    assert any(owner_of[0].get(d) != later.get(d)
               for later in owner_of[1:] for d in later)

    # device 3 is powered down for [20, 60); everyone else is always on
    def presence_secs(d, lo, hi):
        secs = hi - lo
        if d == 3:
            secs -= max(0.0, min(hi, 60.0) - max(lo, 20.0))
        return secs

    # rebuild each tenant's idle bill from first principles: ownership
    # snapshots x presence, independent of the kernel's trackers
    expected = {name: {} for name in trace.tenants}
    bounds = [t for t, _ in trace.ownership] + [horizon]
    for (t0, snap), t1 in zip(trace.ownership, bounds[1:]):
        for tenant, allot in snap.items():
            for d in allot:
                secs = presence_secs(d, t0, min(t1, horizon))
                if secs > 0.0:
                    expected[tenant][d] = \
                        expected[tenant].get(d, 0.0) + secs
    for name, tr in trace.tenants.items():
        assert tr.per_device_idle_s == pytest.approx(expected[name])

    # every present second is billed exactly once across tenants...
    for d in range(4):
        total_idle = sum(tr.per_device_idle_s.get(d, 0.0)
                         for tr in trace.tenants.values())
        assert total_idle == pytest.approx(presence_secs(d, 0.0, horizon))
    # ...so per-device tenant energies add up to the fleet-level bill
    for d, fleet_e in trace.per_device_energy.items():
        tenant_e = sum(tr.per_device_energy.get(d, 0.0)
                       for tr in trace.tenants.values())
        assert tenant_e == pytest.approx(fleet_e, rel=1e-9)


def test_simulate_fleet_session_validation(assist_session):
    with pytest.raises(ValueError, match="armed for fleet"):
        simulate_fleet("traffic_intersection", session=assist_session)
    with pytest.raises(ValueError, match="overrides"):
        simulate_fleet("smart_home_assist", session=assist_session,
                       strategy="dora")


def test_fleet_cli_runs(capsys):
    from repro_torch.scenarios.__main__ import main
    assert main(["--list", "--fleet"]) == 0
    out = capsys.readouterr().out
    assert "smart_home_assist" in out and "fleet scenarios registered" in out


def test_churn_event_with_conditions_reaches_kept_tenants():
    """A churn event can carry condition shifts too; tenants whose
    allotment survives the rebalance unchanged must still absorb them
    (pre-fix the kept-session branch dropped the throttle entirely and
    served at the stale optimistic latency)."""
    sc_a = _tenant("a", "bert", 1.0, 1.0)
    sc_b = _tenant("b", "bert", 1.0, 1.0)
    topo = Topology.shared_medium([CATALOG["rtx4050"],
                                   CATALOG["rtx4050"]], 600.0)
    session = dora.serve_fleet([sc_a, sc_b], topology=topo)
    owner0 = next(n for n, tp in session.plan.tenants.items()
                  if 0 in tp.allotment)
    base = session.sessions[owner0].current.latency
    session.on_dynamics(DynamicsEvent(t=5.0, join=(1,),
                                      compute_speed={0: 0.25}))
    owner0_now = next(n for n, tp in session.plan.tenants.items()
                      if 0 in tp.allotment)
    sess = session.sessions[owner0_now]
    assert sess.state.compute_speed == {0: 0.25}     # throttle recorded
    assert sess.current.latency > base * 2.0         # and priced in


def test_topology_override_never_silently_dropped():
    """``topology=`` must override the shared fleet for registered
    names AND ad-hoc tenant lists, all the way through mode="fleet"
    (pre-fix it was dropped and plans came back for the wrong
    hardware)."""
    three_dev, _ = _home2().subset([0, 2, 3])
    session = dora.serve_fleet("smart_home_assist", topology=three_dev)
    assert session.planner.topo.n == 3
    owned = {d for a in session.assignments.values() for d in a}
    assert owned == {0, 1, 2}
    sc_a = _tenant("a", "bert", 1.0, 1.0)
    sc_b = _tenant("b", "bert", 1.0, 1.0)
    two_dev = Topology.shared_medium([CATALOG["rtx4050"],
                                      CATALOG["rtx4050"]], 600.0)
    trace = dora.simulate([sc_a, sc_b], mode="fleet", topology=two_dev,
                          span_s=5.0)
    owned = {d for a in trace.assignments.values() for d in a}
    assert owned == {0, 1}
    assert set(trace.per_device_energy) == {0, 1}
