"""The port's simulators, fleets and chaos engine against the JAX package's.

Every registered scenario's event replay (``dora.simulate``) and
request-level serving run (``mode="requests"``), every registered fleet's
co-plan (``plan_fleet``), armed session (``serve_fleet``) and fleet serving
run, and chaos runs (``FaultScript.for_session(..., seed=0)`` under both
recovery modes, and a fleet chaos script) through both facades. Both read
one deterministic clock (``torch_parity``): the engines add measured
reaction seconds to stalls and MTTRs, so a raw wall clock would make no two
traces equal. Traces are compared field by field, every request's
arrival, start and finish to 1e-9 relative.
"""
import numpy as np
import pytest

from repro import dora as jdora
from repro.fleet import list_fleets as jlist_fleets
from repro.resilience import Fault as JFault
from repro.resilience import FaultScript as JFaultScript
from repro.scenarios import list_scenarios as jlist_scenarios
from repro_torch import dora
from repro_torch.resilience import Fault, FaultScript
from torch_parity import REL, both, close_tree, same_plan

SCENARIOS = jlist_scenarios()
FLEETS = jlist_fleets()
RECOVERY = ("ladder", "replan")


def same_requests(got, want, where) -> None:
    """Two ``RequestLog``s: the same requests at the same times."""
    assert len(got) == len(want), where
    for name in ("arrival", "start", "finish"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=REL,
                                   atol=0.0, err_msg=f"{where} {name}")
    for name in ("class_id", "attempts", "hedged"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), (where, name)
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


def same_serving(got, want, where) -> None:
    close_tree(got.to_dict(), want.to_dict(), where)
    same_requests(got.requests, want.requests, where)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_simulate_events_matches_jax(monkeypatch, scenario):
    got, want = both(monkeypatch, lambda: jdora.simulate(scenario),
                     lambda: dora.simulate(scenario))
    close_tree(got.to_dict(), want.to_dict(), scenario)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_simulate_requests_matches_jax(monkeypatch, scenario):
    got, want = both(monkeypatch, lambda: jdora.simulate(scenario, mode="requests"),
                     lambda: dora.simulate(scenario, mode="requests"))
    same_serving(got, want, scenario)


@pytest.mark.parametrize("fleet", FLEETS)
def test_plan_fleet_matches_jax(monkeypatch, fleet):
    got, want = both(monkeypatch, lambda: jdora.plan_fleet(fleet),
                     lambda: dora.plan_fleet(fleet))
    close_tree(got.to_dict(), want.to_dict(), fleet)
    for name, t in want.tenants.items():
        same_plan(got.tenants[name].plan, t.plan, (fleet, name))
    assert got.summary() == want.summary()


@pytest.mark.parametrize("fleet", FLEETS)
def test_serve_fleet_and_its_serving_run_match_jax(monkeypatch, fleet):
    def run(facade):
        session = facade.serve_fleet(fleet)
        return session, facade.simulate(fleet, mode="fleet", session=session, seed=1)
    (got, gtr), (want, wtr) = both(monkeypatch, lambda: run(jdora), lambda: run(dora))
    close_tree(got.plan.to_dict(), want.plan.to_dict(), fleet)
    close_tree(gtr.to_dict(), wtr.to_dict(), fleet)
    for name, t in wtr.tenants.items():
        same_requests(gtr.tenants[name].requests, t.requests, (fleet, name))


@pytest.mark.parametrize("recovery", RECOVERY)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_chaos_run_matches_jax(monkeypatch, scenario, recovery):
    def run(facade, script_cls):
        session = facade.serve(scenario)
        script = script_cls.for_session(session, seed=0)
        trace = facade.simulate(scenario, mode="requests", session=session, copy=True,
                                faults=script, recovery=recovery)
        return script, trace
    (gs, got), (ws, want) = both(monkeypatch, lambda: run(jdora, JFaultScript),
                                 lambda: run(dora, FaultScript))
    assert repr(gs) == repr(ws)
    same_serving(got, want, (scenario, recovery))
    assert got.faults and got.mttr_s == pytest.approx(want.mttr_s, rel=REL)


@pytest.mark.parametrize("recovery", RECOVERY)
@pytest.mark.parametrize("fleet", FLEETS)
def test_fleet_chaos_run_matches_jax(monkeypatch, fleet, recovery):
    def run(facade, fault, script_cls):
        script = script_cls((fault("crash", 8.0, 1, duration=30.0),
                             fault("straggler", 50.0, 2, duration=25.0, factor=0.4)))
        return facade.simulate(fleet, mode="fleet", session=facade.serve_fleet(fleet),
                               faults=script, recovery=recovery, seed=1)
    got, want = both(monkeypatch, lambda: run(jdora, JFault, JFaultScript),
                     lambda: run(dora, Fault, FaultScript))
    close_tree(got.to_dict(), want.to_dict(), (fleet, recovery))
    for name, t in want.tenants.items():
        same_requests(got.tenants[name].requests, t.requests, (fleet, name))
