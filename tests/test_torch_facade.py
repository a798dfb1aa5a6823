"""The port's copy of Dora's planning stack (``repro_torch.scenarios``,
``strategies``, ``control``, ``dora``, ``sim``, ``fleet``, ``resilience``,
``core.events`` and ``runtime.heartbeat``) against the JAX package's.

Each copied module is held to its original line for line. Every registered
scenario is planned with every registered strategy by both facades: stage
``node_ids`` and ``devices`` and the microbatch geometry exactly, objective,
latency and energy and every other number of the report to 1e-9 relative,
or both must raise the same error. ``compare`` and planning with the
committed H100 calibration are held the same way. Both packages read one
deterministic clock (``torch_parity``), so measured planning seconds agree
too. Registry objects never cross packages: only their fields are compared.
"""
import os
import re

import pytest

from repro import dora as jdora
from repro.fleet import list_fleets as jlist_fleets
from repro.scenarios import get_scenario as jget_scenario
from repro.scenarios import list_scenarios as jlist_scenarios
from repro.strategies import list_strategies as jlist_strategies
from repro_torch import dora
from repro_torch.fleet import list_fleets
from repro_torch.scenarios import get_scenario, list_scenarios
from repro_torch.strategies import list_strategies
from torch_parity import both, close_tree, same_plan

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
H100 = os.path.join(ROOT, "calibration", "h100.json")

COPIES = [
    "core/events.py", "runtime/heartbeat.py",
    "scenarios/__init__.py", "scenarios/catalog.py", "scenarios/generate.py",
    "scenarios/__main__.py",
    "strategies/__init__.py", "strategies/base.py", "strategies/baselines.py",
    "strategies/dora_strategy.py", "strategies/splits.py",
    "control/__init__.py", "control/battery.py", "control/plane.py",
    "dora.py",
    "sim/__init__.py", "sim/kernel.py", "sim/serving.py", "sim/fleet.py", "sim/runner.py",
    "sim/baselines.py",
    "fleet/__init__.py", "fleet/catalog.py", "fleet/planner.py", "fleet/session.py",
    "resilience/__init__.py", "resilience/faults.py", "resilience/ladder.py",
    "resilience/engine.py",
]
# (the original line or its start, the port's line) for each line of a
# docstring that the mapping alone would leave false in the port
REWORDED = {
    "dora.py": [("    from repro import dora", "    from repro_torch import dora"),
                ("    The only facade verb that touches jax: it runs the",
                 "    The only facade verb that touches a device: it runs the")],
    "scenarios/catalog.py": [
        ("    target of the jax_pallas substrate): ICI-class 50 GB/s links.\"\"\"",
         "    target of the JAX package's substrate): ICI-class 50 GB/s links.\"\"\"")],
    # a reference to the JAX package's change history, which is not the port's
    "resilience/faults.py": [("Scripts compose with the ",
                              "Scripts compose with the generated scenario families: pass")],
}

SCENARIOS = jlist_scenarios()
STRATEGIES = jlist_strategies()


def mapped(text: str) -> str:
    """The JAX package's text as the port reads it."""
    return re.sub(r"\brepro\.", "repro_torch.", text)


# -- the copies ------------------------------------------------------------------------
@pytest.mark.parametrize("path", COPIES)
def test_module_is_a_verbatim_copy(path):
    """A two-line header, then the original with ``repro.`` read as
    ``repro_torch.``; only the lines of ``REWORDED`` differ."""
    with open(os.path.join(SRC, "repro", path), encoding="utf-8") as f:
        want = mapped(f.read()).splitlines()
    with open(os.path.join(SRC, "repro_torch", path), encoding="utf-8") as f:
        got = f.read().splitlines()
    assert got[0] == f"# A copy of src/repro/{path} (the port imports nothing of the " \
                     "JAX package)."
    assert got[1].startswith("# Keep it verbatim: ")
    got = got[2:]
    assert len(got) == len(want)
    changed = [(w, g) for w, g in zip(want, got) if w != g]
    expect = REWORDED.get(path, [])
    assert [g for _, g in changed] == [b for _, b in expect]
    assert all(w.startswith(mapped(a)) for (w, _), (a, _) in zip(changed, expect))


def test_registries_are_the_references():
    assert list_scenarios() == SCENARIOS
    assert list_strategies() == STRATEGIES
    assert list_fleets() == jlist_fleets()
    for name in SCENARIOS:
        got, want = get_scenario(name), jget_scenario(name)
        for field in ("name", "description", "model_name", "mode", "seq_len", "tags",
                      "request_rate"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert got.summary_row() == want.summary_row()
        assert (repr(got.arrival), repr(got.request_classes)) == \
            (repr(want.arrival), repr(want.request_classes)), name
        topo, jtopo = got.build_topology(), want.build_topology()
        assert (repr(topo.devices), repr(topo.resources), repr(topo._p2p)) == \
            (repr(jtopo.devices), repr(jtopo.resources), repr(jtopo._p2p)), name
        assert vars(got.workload) == vars(want.workload), name
        assert vars(got.qoe) == vars(want.qoe), name
        assert [(label, vars(e)) for label, e in got.timeline] == \
            [(label, vars(e)) for label, e in want.timeline], name


# -- plans -----------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plan_matches_jax(monkeypatch, scenario, strategy):
    got, want = both(monkeypatch, lambda: jdora.plan(scenario, strategy=strategy),
                     lambda: dora.plan(scenario, strategy=strategy))
    if want is None:
        return
    same_plan(got.best, want.best, (scenario, strategy))
    assert [p.summary() for p in got.pareto] == [p.summary() for p in want.pareto]
    assert len(got.candidates) == len(want.candidates)
    close_tree(got.to_dict(), want.to_dict(), f"{scenario}/{strategy}")
    assert got.summary() == want.summary()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_compare_matches_jax(monkeypatch, scenario):
    got, want = both(monkeypatch, lambda: jdora.compare(scenario),
                     lambda: dora.compare(scenario))
    close_tree(got.to_dict(), want.to_dict(), scenario)
    assert got.summary() == want.summary()
    for name in want.strategies:
        if want[name].ok:
            same_plan(got[name].result.best, want[name].result.best, (scenario, name))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plan_with_the_committed_h100_costs_matches_jax(monkeypatch, scenario):
    costs = f"profiled:{H100}"
    got, want = both(monkeypatch, lambda: jdora.plan(scenario, costs=costs),
                     lambda: dora.plan(scenario, costs=costs))
    same_plan(got.best, want.best, scenario)
    close_tree(got.to_dict(), want.to_dict(), scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_serve_and_its_timeline_match_jax(monkeypatch, scenario):
    """``dora.serve`` armed with the control plane, each timeline event fed
    to ``on_dynamics``: the same actions and plans."""
    def run(facade):
        session = facade.serve(scenario)
        steps = [session.on_dynamics(ev) for _, ev in session.report.scenario.timeline]
        return session, steps
    (got, gsteps), (want, wsteps) = both(monkeypatch, lambda: run(jdora), lambda: run(dora))
    same_plan(got.report.best, want.report.best, scenario)
    assert len(gsteps) == len(wsteps)
    for (gp, ga, gs), (wp, wa, ws) in zip(gsteps, wsteps):
        assert (ga, gs) == (wa, ws), scenario
        same_plan(gp, wp, (scenario, wa))
    assert (got.active, got.plan_fleet, got.degraded, got.meets_qoe) == \
        (want.active, want.plan_fleet, want.degraded, want.meets_qoe)
