# Mirror of tests/test_scenarios.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Scenario registry + ``repro_torch.dora`` facade."""
import pytest

from repro_torch import dora
from repro_torch.core.cost_model import Workload
from repro_torch.core.device import CATALOG, Topology
from repro_torch.core.graph_builders import GraphSpec, build_lm_graph
from repro_torch.core.qoe import QoESpec
from repro_torch.scenarios import (PAPER_SETTINGS, Scenario, get_scenario,
                             iter_scenarios, list_scenarios, register)
from repro_torch.sim.runner import scenario_case


def test_registry_has_paper_and_new_scenarios():
    names = list_scenarios()
    assert len(names) >= 7
    for s in PAPER_SETTINGS:
        assert s in names
    assert len(set(names) - set(PAPER_SETTINGS)) >= 3   # beyond the paper


def test_every_scenario_builds():
    for sc in iter_scenarios():
        topo = sc.build_topology()
        graph = sc.build_graph()
        assert topo.n >= 2, sc.name
        assert len(graph.nodes) >= 3, sc.name
        assert sc.mode in ("train", "serve")
        # serving scenarios plan per-token
        if sc.mode == "serve" and isinstance(sc.model, str):
            assert graph.nodes[1].act_bytes <= 2.0 * 8192, sc.name


def test_build_topology_returns_fresh_copies():
    """The fresh-copy contract: ``build_topology()`` re-invokes the
    factory, so two calls never alias mutable ``Topology`` state
    (resource objects, device lists, memo caches) across sessions —
    one session's calibration or bandwidth scaling must not leak into
    another's."""
    from repro_torch.scenarios.generate import generate
    for sc in list(iter_scenarios()) + [generate("lossy_mesh", 1)]:
        t1, t2 = sc.build_topology(), sc.build_topology()
        assert t1 is not t2, sc.name
        assert t1.devices is not t2.devices, sc.name
        assert t1.resources is not t2.resources, sc.name
        for name, r1 in t1.resources.items():
            assert r1 is not t2.resources[name], (sc.name, name)
        # scaling one copy leaves the sibling untouched
        res = next(iter(t1.resources))
        scaled = t1.scale_resources({res: 0.5})
        assert scaled.resources[res].capacity \
            == pytest.approx(t2.resources[res].capacity * 0.5), sc.name
        assert t2.resources[res].capacity \
            == pytest.approx(t1.resources[res].capacity), sc.name


def test_get_scenario_unknown_name_lists_known():
    with pytest.raises(KeyError, match="smart_home_2"):
        get_scenario("no_such_deployment")


def test_register_rejects_duplicates():
    sc = get_scenario("smart_home_2")
    with pytest.raises(ValueError):
        register(sc)


def test_list_scenarios_tag_filter():
    paper = list_scenarios(tag="paper")
    assert sorted(paper) == sorted(PAPER_SETTINGS)


def test_dora_plan_returns_plan_report():
    report = dora.plan("smart_home_2")
    assert isinstance(report, dora.PlanReport)
    assert report.latency > 0
    assert report.energy > 0
    assert len(report.pareto) >= 1
    assert report.meets_qoe          # the registered QoE must be plannable
    assert "smart_home_2" in report.summary()


def test_dora_plan_accepts_overrides():
    loose = dora.plan("smart_home_2")
    tight = dora.plan("smart_home_2",
                      qoe=QoESpec(t_qoe=0.0, lam=1e15))
    assert tight.latency <= loose.latency * (1 + 1e-9)


def _adhoc_scenario():
    spec = GraphSpec("tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=256, vocab=1000, seq_len=32)
    return Scenario(
        name="adhoc_test",
        description="two phones on WiFi (unregistered)",
        topology=lambda: Topology.shared_medium(
            [CATALOG["s25"], CATALOG["mi15"]], 300.0),
        model=lambda seq_len: build_lm_graph(spec, seq_len=seq_len),
        workload=Workload(global_batch=8, microbatch_size=2,
                          optimizer_mult=3.0),
        qoe=QoESpec(t_qoe=5.0, lam=10.0), seq_len=32)


def test_dora_plan_adhoc_scenario():
    report = dora.plan(_adhoc_scenario())
    assert report.scenario.name == "adhoc_test"
    assert report.latency > 0
    # an ad-hoc scenario must NOT leak into the registry
    assert "adhoc_test" not in list_scenarios()


def test_dora_serve_and_dynamics():
    from repro_torch.core.adapter import DynamicsEvent
    session = dora.serve(_adhoc_scenario())
    base = session.current.latency
    plan, action, react = session.on_dynamics(
        DynamicsEvent(t=1.0, compute_speed={0: 0.95}))
    assert action == "reschedule"            # ≤10% shift: network-only
    assert session.current is plan
    plan2, action2, _ = session.on_dynamics(
        DynamicsEvent(t=2.0, compute_speed={0: 0.4}))
    assert action2 == "replan"
    assert base > 0 and plan2.latency > 0


def test_dora_simulate_default_timeline():
    trace = dora.simulate("retail_analytics")
    assert len(trace.steps) == 2             # registered timeline length
    assert all(s.action in ("reschedule", "replan") for s in trace.steps)
    assert "QoE" in trace.summary()


def test_scenario_case_respects_scenario_defaults():
    topo, graph, wl = scenario_case("smart_home_2")
    sc = get_scenario("smart_home_2")
    assert topo.n == sc.build_topology().n
    assert wl == sc.workload


def test_scenario_case_mode_override():
    _, graph_t, wl_t = scenario_case("traffic_monitor", model="qwen3-0.6b",
                                     mode="train")
    _, graph_s, wl_s = scenario_case("traffic_monitor")
    assert wl_t.training and not wl_s.training
    # train graphs carry the full sequence; serving plans per token
    assert graph_t.nodes[1].act_bytes > graph_s.nodes[1].act_bytes


def test_cli_list(capsys):
    from repro_torch.scenarios.__main__ import main
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in PAPER_SETTINGS:
        assert name in out
    assert "scenarios registered" in out
    # generated-family coverage line (job logs show generator coverage)
    assert "generator families" in out
    assert "lossy_mesh:1" in out
    assert "mixed_train_serve:1" in out


def test_cli_generate(capsys):
    from repro_torch.scenarios.__main__ import main
    assert main(["--generate", "lossy_mesh", "--seed", "1",
                 "--count", "2"]) == 0
    out = capsys.readouterr().out
    assert "gen/lossy_mesh/0001" in out
    assert "gen/lossy_mesh/0002" in out
    assert "QoE" in out
    assert main(["--generate", "no_such_family"]) == 1
    assert "unknown generator family" in capsys.readouterr().err
