# Mirror of tests/test_strategies.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Planner-strategy registry, cost providers, dora.compare, JSON export."""
import json
import math
import pickle

import pytest

from repro_torch import dora
from repro_torch.core.cost_model import ANALYTIC_COSTS, AnalyticCosts, CostProvider
from repro_torch.core.partitioner import PartitionerConfig
from repro_torch.core.planner import DoraPlanner, PlanningResult
from repro_torch.core.profiler import ProfiledCosts
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.scenarios import get_scenario, list_scenarios
from repro_torch.strategies import (StrategyError, get_strategy, list_strategies,
                              register_strategy)
from repro_torch.strategies import base as strategies_base

EXPECTED = {"dora", "throughput_max", "memory_balanced", "chain_split",
            "pareto_split", "edgeshard", "asteroid", "alpa", "metis",
            "brute_force"}

# cheap search knobs so the full strategy x scenario sweep stays fast;
# the strategies themselves are unchanged
FAST_PARAMS = {
    "dora": dict(partitioner_config=PartitionerConfig(top_k=2)),
    "brute_force": dict(shortlist=4, max_stages=3),
}


@pytest.fixture(scope="module")
def catalog_cases():
    out = {}
    for name in list_scenarios():
        sc = get_scenario(name)
        out[name] = (sc.build_topology(), sc.build_graph(), sc.qoe,
                     sc.workload)
    return out


# -- registry ------------------------------------------------------------------
def test_builtin_strategies_registered():
    assert EXPECTED <= set(list_strategies())


def test_unknown_strategy_lists_registered_names():
    with pytest.raises(ValueError) as ei:
        get_strategy("no_such_planner")
    msg = str(ei.value)
    assert "no_such_planner" in msg
    for name in ("dora", "chain_split", "throughput_max"):
        assert name in msg


def test_register_rejects_duplicates_and_anonymous():
    with pytest.raises(ValueError):
        @register_strategy
        class Dupe:  # noqa: D401
            name = "dora"
    with pytest.raises(ValueError):
        @register_strategy
        class NoName:
            pass


def test_custom_strategy_registers_and_resolves():
    @register_strategy
    class Custom:
        name = "custom_test_strategy"
        contention_aware = False

        def plan(self, graph, topology, qoe, workload, costs=None):
            raise StrategyError("stub")
    try:
        strat = get_strategy("custom_test_strategy")
        assert strat.name == "custom_test_strategy"
    finally:
        strategies_base._REGISTRY.pop("custom_test_strategy")


def test_get_strategy_passes_instances_through():
    inst = get_strategy("chain_split")
    assert get_strategy(inst) is inst
    with pytest.raises(ValueError):
        get_strategy(inst, top_k=3)     # params need name resolution


# -- every strategy plans the whole catalogue ---------------------------------
@pytest.mark.parametrize("strategy", sorted(EXPECTED))
def test_strategy_plans_all_catalog_scenarios(strategy, catalog_cases):
    strat = get_strategy(strategy, **FAST_PARAMS.get(strategy, {}))
    for name, (topo, graph, qoe, wl) in catalog_cases.items():
        res = strat.plan(graph, topo, qoe, wl)
        assert isinstance(res, PlanningResult), name
        assert res.best.latency > 0.0, name
        assert res.best.energy > 0.0, name
        assert res.pareto, name
        covered = sorted(i for s in res.best.stages for i in s.node_ids)
        g = res.best.meta.get("graph")
        if g is not None:
            assert covered == list(range(len(g.nodes))), name


# -- dora strategy == DoraPlanner ---------------------------------------------
def _plan_sig(plan):
    return pickle.dumps(
        [(tuple(s.node_ids), tuple(s.devices),
          sorted(s.microbatch_split.items()), s.tp_degree,
          s.fwd_time, s.bwd_time) for s in plan.stages]
        + [plan.latency, plan.energy, plan.objective,
           plan.microbatch_size, plan.n_microbatches])


def test_dora_strategy_byte_identical_to_planner(catalog_cases):
    topo, graph, qoe, wl = catalog_cases["traffic_monitor"]
    pcfg = PartitionerConfig(top_k=3)
    # unbounded chunk-search budget -> fully deterministic refinement
    scfg = SchedulerConfig(time_budget_s=1e9)
    via_registry = get_strategy("dora", partitioner_config=pcfg,
                                scheduler_config=scfg).plan(graph, topo, qoe,
                                                            wl)
    direct = DoraPlanner(graph, topo, qoe, partitioner_config=pcfg,
                         scheduler_config=scfg).plan(wl)
    assert _plan_sig(via_registry.best) == _plan_sig(direct.best)
    assert [_plan_sig(p) for p in via_registry.candidates] \
        == [_plan_sig(p) for p in direct.candidates]
    assert [_plan_sig(p) for p in via_registry.pareto] \
        == [_plan_sig(p) for p in direct.pareto]


# -- cost providers ------------------------------------------------------------
def test_analytic_costs_is_identity(catalog_cases):
    topo, _, _, _ = catalog_cases["traffic_monitor"]
    assert isinstance(ANALYTIC_COSTS, CostProvider)
    assert ANALYTIC_COSTS.calibrate(topo) is topo
    assert isinstance(AnalyticCosts(), CostProvider)


def test_profiled_costs_slow_down_plans(catalog_cases):
    # training is compute-bound, so halved measured throughput must show
    topo, graph, qoe, wl = catalog_cases["smart_home_2"]
    strat = get_strategy("chain_split")
    base = strat.plan(graph, topo, qoe, wl)
    slow = strat.plan(graph, topo, qoe, wl,
                      costs=ProfiledCosts(default_compute=0.5))
    assert isinstance(ProfiledCosts(), CostProvider)
    assert slow.best.latency > base.best.latency * 1.2


def test_profiled_costs_from_measurements():
    pc = ProfiledCosts.from_measurements(
        device_seconds={"s25": (1.0, 2.0)},            # measured 2x slower
        link_bytes_per_s={"wifi": (100e6, 50e6)})      # half the goodput
    assert pc.compute_factor["s25"] == pytest.approx(0.5)
    assert pc.bandwidth_factor["wifi"] == pytest.approx(0.5)
    topo = get_scenario("smart_home_2").build_topology()
    cal = pc.calibrate(topo)
    for d0, d1 in zip(topo.devices, cal.devices):
        want = 0.5 if d0.name == "s25" else 1.0
        assert d1.compute_efficiency == pytest.approx(
            d0.compute_efficiency * want)
    assert cal.resources["wifi"].capacity == pytest.approx(
        topo.resources["wifi"].capacity * 0.5)


def test_facade_accepts_costs():
    fast = dora.plan("smart_home_2", strategy="chain_split")
    slow = dora.plan("smart_home_2", strategy="chain_split",
                     costs=ProfiledCosts(default_compute=0.25,
                                         default_bandwidth=0.25))
    assert slow.latency > fast.latency


# -- dora.compare --------------------------------------------------------------
@pytest.fixture(scope="module")
def sh2_compare():
    return dora.compare("smart_home_2",
                        strategies=["dora", "throughput_max", "chain_split"])


def test_compare_returns_comparison_report(sh2_compare):
    cmp = sh2_compare
    assert isinstance(cmp, dora.ComparisonReport)
    assert cmp.strategies == ["dora", "throughput_max", "chain_split"]
    assert cmp.reference == "dora"
    assert all(cmp[s].ok for s in cmp.strategies)
    assert "smart_home_2" in cmp.summary()


def test_compare_dora_holds_headline_claim(sh2_compare):
    """Acceptance: dora meets QoE and beats >=1 baseline by >=1.1x latency
    or >=21% energy on this catalog scenario."""
    cmp = sh2_compare
    assert cmp.meets_qoe("dora")
    advantages = [(cmp.speedup(s), cmp.energy_savings(s))
                  for s in cmp.strategies if s != "dora" and cmp[s].ok]
    assert any(sp >= 1.1 or sv >= 0.21 for sp, sv in advantages), advantages


def test_compare_json_roundtrip(tmp_path, sh2_compare):
    path = tmp_path / "cmp.json"
    text = sh2_compare.to_json(str(path))
    on_disk = json.loads(path.read_text())
    assert json.loads(text) == on_disk
    rows = on_disk["strategies"]
    assert rows["dora"]["meets_qoe"] is True
    assert rows["chain_split"]["speedup_vs_reference"] > 0
    for row in rows.values():                    # strict-JSON safe
        assert row["latency_s"] is None or math.isfinite(row["latency_s"])


def test_compare_failure_is_a_row_not_an_exception():
    class Failing:
        name = "failing"
        contention_aware = False

        def plan(self, graph, topology, qoe, workload, costs=None):
            raise StrategyError("boom")

    cmp = dora.compare("traffic_monitor",
                       strategies=["chain_split", Failing()])
    assert not cmp["failing"].ok
    assert "boom" in cmp["failing"].error
    assert cmp["failing"].latency == math.inf
    assert cmp.reference == "chain_split"        # first ok fallback
    assert math.isnan(cmp.speedup("failing"))


# -- facade strategy selection -------------------------------------------------
def test_plan_with_strategy_name():
    rep = dora.plan("traffic_monitor", strategy="chain_split")
    assert rep.strategy == "chain_split"
    assert rep.latency > 0
    assert "chain_split" in rep.summary()


def test_plan_rejects_dora_configs_for_other_strategies():
    with pytest.raises(ValueError, match="dora"):
        dora.plan("traffic_monitor", strategy="chain_split",
                  partitioner_config=PartitionerConfig(top_k=2))


def test_plan_report_to_dict_is_json_safe():
    rep = dora.plan("traffic_monitor", strategy="pareto_split")
    d = rep.to_dict()
    json.dumps(d, allow_nan=False)
    assert d["strategy"] == "pareto_split"
    assert d["scenario"] == "traffic_monitor"
    assert d["best"]["stages"]
    assert len(d["pareto"]) == len(rep.pareto)


# -- simulate copy escape hatch ------------------------------------------------
def test_simulate_mutates_session_by_default_copy_preserves():
    session = dora.serve("retail_analytics")
    before = session.current
    trace = dora.simulate("retail_analytics", session=session, copy=True)
    assert session.current is before             # caller session untouched
    assert len(trace.steps) == 2
    dora.simulate("retail_analytics", session=session)
    # documented contract: without copy=True the session advances
    assert session.current is not before


# -- CLI -----------------------------------------------------------------------
def test_cli_strategies_flag(capsys):
    from repro_torch.scenarios.__main__ import main
    assert main(["--strategies"]) == 0
    out = capsys.readouterr().out
    for name in EXPECTED:
        assert name in out


def test_cli_run_with_strategy_and_json(tmp_path, capsys):
    from repro_torch.scenarios.__main__ import main
    path = tmp_path / "run.json"
    assert main(["--run", "traffic_monitor", "--strategy", "chain_split",
                 "--json", str(path)]) == 0
    doc = json.loads(path.read_text())
    assert doc["scenarios"]["traffic_monitor"]["plan"]["strategy"] \
        == "chain_split"


def test_cli_compare_json(tmp_path, capsys):
    from repro_torch.scenarios.__main__ import main
    path = tmp_path / "cmp.json"
    assert main(["--run", "traffic_monitor", "--compare", "chain_split",
                 "memory_balanced", "--json", str(path)]) == 0
    doc = json.loads(path.read_text())
    rows = doc["scenarios"]["traffic_monitor"]["compare"]["strategies"]
    assert set(rows) == {"chain_split", "memory_balanced"}
