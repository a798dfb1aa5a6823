"""The port's copy of Dora's planner (``repro_torch.core``, ``repro_torch.dora``,
``repro_torch.models.registry.planning_graph`` and the serve launcher's
``--setting`` / ``--dynamics``) against the JAX package's.

The copies are held to their originals line for line, the planning graphs
node for node, and the plans as ``tests/test_planner_golden.py`` holds the
planner to its golden file: stage ``node_ids`` and ``devices`` and the
microbatch geometry exactly, objective, latency and energy to 1e-9
relative. The cases are the four Table 3 settings x granite-8b,
h2o-danube-1.8b, qwen3-32b and reduced qwen3-32b at 4096 tokens x the
serve launcher's workload (batch 4 of 1, 200 ms, lambda 100) and a train
workload (batch 8 of 2, 8 s, lambda 50); the infeasible cases (qwen3-32b
serving in every setting among them) must raise the same error. The runtime
adapter's reaction to the launcher's dynamics event must give the same
action and plan (react seconds are wall time and are not compared). Two
catalogue scenarios beyond Table 3 (retail_analytics, vehicle_platoon) plan
and launch as the JAX package's; the rest of the planning stack is held in
``tests/test_torch_facade.py`` and ``tests/test_torch_sim.py``.
"""
import difflib
import inspect
import os
import re
import subprocess
import sys

import pytest

from repro import dora as jdora
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.control.plane import react_once as jreact_once
from repro.core import DynamicsEvent as JDynamicsEvent
from repro.core import QoESpec as JQoESpec
from repro.core import Workload as JWorkload
from repro.models.registry import planning_graph as jplanning_graph
from repro_torch import dora
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core import DynamicsEvent, QoESpec, Workload
from repro_torch.control import plane as tplane
from repro_torch.core import adapter as tadapter
from repro_torch.launch import serve
from repro_torch.models.registry import planning_graph
from repro_torch.scenarios import get_scenario
from torch_parity import same_plan

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
CORE = ["planning_graph", "plans", "qoe", "device", "profiler", "cost_model", "engine", "cep",
        "scheduler", "partitioner", "adapter", "planner", "graph_builders"]
SETTINGS = ["smart_home_1", "smart_home_2", "traffic_monitor", "edge_cluster"]
MODELS = ["granite_8b", "h2o_danube_1_8b", "qwen3_32b", "qwen3_32b_reduced"]
SEQ = 4096
# (global batch, microbatch, training, t_qoe s, lambda): the serve launcher's
# defaults and the train workload the card runs h2o-danube-1.8b with
WORKLOADS = {"serve": (4, 1, False, 0.2, 100.0), "train": (8, 2, True, 8.0, 50.0)}
EVENT = dict(compute_speed={0: 0.6}, bandwidth_scale={"wifi": 0.7})


# -- the copies --------------------------------------------------------------------
@pytest.mark.parametrize("name", CORE)
def test_core_module_is_a_verbatim_copy(name):
    """Each module of ``repro_torch/core`` is its JAX counterpart after a
    two-line header, with ``repro.`` read as ``repro_torch.`` in its
    docstrings."""
    with open(os.path.join(SRC, "repro", "core", f"{name}.py"), encoding="utf-8") as f:
        want = re.sub(r"\brepro\.", "repro_torch.", f.read()).splitlines()
    with open(os.path.join(SRC, "repro_torch", "core", f"{name}.py"), encoding="utf-8") as f:
        got = f.read().splitlines()
    assert got[0] == f"# A copy of src/repro/core/{name}.py (the port imports nothing of the " \
                     "JAX package)."
    got = got[2:]
    diff = [d for d in difflib.unified_diff(want, got, lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]
    assert diff == []


def test_react_once_is_a_copy():
    """The adapter reaches its reaction through the port's control plane,
    whose ``react_once`` is the reference's."""
    assert inspect.getsource(tplane.react_once) == inspect.getsource(jreact_once)
    assert "from ..control.plane import react_once" in inspect.getsource(
        tadapter.RuntimeAdapter.on_dynamics)


# -- planning graphs -------------------------------------------------------------------
def _graph_rows(g):
    return [vars(n) for n in g.nodes], list(g.edges)


@pytest.mark.parametrize("seq", [32, 4096])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planning_graph_matches_jax(arch, seq):
    assert ARCH_IDS == J_ARCH_IDS
    for tcfg, jcfg in ((get_config(arch), jget_config(arch)),
                       (reduced_config(arch), jreduced_config(arch))):
        got, want = _graph_rows(planning_graph(tcfg, seq)), _graph_rows(jplanning_graph(jcfg, seq))
        assert len(got[0]) == len(want[0]) > 0
        assert got == want, (arch, seq, tcfg.name)


# -- plans -----------------------------------------------------------------------------------
def _cfgs(model):
    if model.endswith("_reduced"):
        arch = model[:-len("_reduced")]
        return reduced_config(arch), jreduced_config(arch)
    return get_config(model), jget_config(model)


def _plan_both(setting, model, kind):
    tcfg, jcfg = _cfgs(model)
    gb, mb, training, t_qoe, lam = WORKLOADS[kind]
    got = want = None
    try:
        want = jdora.serve(setting, graph=jplanning_graph(jcfg, SEQ),
                           qoe=JQoESpec(t_qoe=t_qoe, lam=lam),
                           workload=JWorkload(global_batch=gb, microbatch_size=mb,
                                              training=training))
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=re.escape(str(e))):
            dora.serve(setting, graph=planning_graph(tcfg, SEQ), qoe=QoESpec(t_qoe=t_qoe, lam=lam),
                       workload=Workload(global_batch=gb, microbatch_size=mb, training=training))
        return None, None
    got = dora.serve(setting, graph=planning_graph(tcfg, SEQ), qoe=QoESpec(t_qoe=t_qoe, lam=lam),
                     workload=Workload(global_batch=gb, microbatch_size=mb, training=training))
    return got, want


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("setting", SETTINGS)
def test_plan_matches_jax(setting, model, kind):
    got, want = _plan_both(setting, model, kind)
    if want is None:                  # both raised the same error
        return
    ctx = (setting, model, kind)
    same_plan(got.report.result.best, want.report.result.best, ctx)
    assert got.current.summary() == want.current.summary()
    assert len(got.report.result.pareto) == len(want.report.result.pareto), ctx
    assert len(got.report.result.candidates) == len(want.report.result.candidates), ctx
    # the launcher's dynamics event, fed to each adapter
    p_got, a_got, _ = got.adapter.on_dynamics(got.current, DynamicsEvent(t=1.0, **EVENT))
    p_want, a_want, _ = want.adapter.on_dynamics(want.current, JDynamicsEvent(t=1.0, **EVENT))
    assert a_got == a_want, ctx
    same_plan(p_got, p_want, ctx + ("dynamics",))


def test_the_issue_plans_have_the_stages_the_card_runs():
    """The two plans chip_smoke runs: granite-8b on smart_home_2 in three
    stages, h2o-danube-1.8b on traffic_monitor (train) in four."""
    got, _ = _plan_both("smart_home_2", "granite_8b", "serve")
    assert [len(s.node_ids) for s in got.current.stages] == [13, 12, 13]
    assert (got.current.microbatch_size, got.current.n_microbatches) == (1, 4)
    got, _ = _plan_both("traffic_monitor", "h2o_danube_1_8b", "train")
    assert [len(s.node_ids) for s in got.current.stages] == [9, 8, 5, 4]
    assert (got.current.microbatch_size, got.current.n_microbatches) == (2, 4)


@pytest.mark.parametrize("setting", SETTINGS)
def test_qwen3_32b_serving_is_infeasible_in_every_setting(setting):
    assert _plan_both(setting, "qwen3_32b", "serve") == (None, None)


@pytest.mark.parametrize("setting", SETTINGS)
def test_setting_defaults_match_the_scenario_catalogue(setting):
    """With no overrides a Table 3 setting plans its catalogue model,
    workload and QoE, as ``repro.dora.serve(name)`` does."""
    got, want = dora.serve(setting), jdora.serve(setting)
    same_plan(got.current, want.current, setting)
    assert got.report.workload == get_scenario(setting).workload
    assert vars(got.report.workload) == vars(want.report.workload)
    assert vars(got.report.qoe) == vars(want.report.qoe)


@pytest.mark.parametrize("name", ["retail_analytics", "vehicle_platoon", "nowhere"])
def test_a_setting_outside_table3_raises(name):
    """Settings beyond Table 3 plan as the JAX package plans them; only an
    unregistered name raises, with the reference's ``KeyError``."""
    try:
        want = jdora.serve(name)
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            dora.serve(name)
        assert str(got.value) == str(e)
        with pytest.raises(KeyError) as got:
            get_scenario(name)
        assert str(got.value) == str(e)
        return
    got = dora.serve(name)
    same_plan(got.current, want.current, name)
    assert got.current.summary() == want.current.summary()
    assert vars(got.report.workload) == vars(want.report.workload)
    assert vars(got.report.qoe) == vars(want.report.qoe)


# -- the serve launcher ----------------------------------------------------------------------
LAUNCH = ["--arch", "qwen3_32b", "--reduced", "--batch", "2", "--prompt-len", "12",
          "--gen-len", "4", "--device", "cpu"]


@pytest.mark.parametrize("setting", ["smart_home_2", "edge_cluster"])
def test_launcher_prints_jaxs_plan_and_dynamics(capsys, setting):
    out = serve.main(LAUNCH + ["--setting", setting, "--dynamics"])
    text = capsys.readouterr().out
    want = jdora.serve(setting, graph=jplanning_graph(jreduced_config("qwen3_32b"), 12),
                       qoe=JQoESpec(t_qoe=0.2, lam=100.0),
                       workload=JWorkload(global_batch=2, microbatch_size=1, training=False))
    best = want.report.result.best
    assert f"Dora plan: {best.summary()}" in text
    assert out["plan_summary"] == best.summary()
    same_plan(out["plan"], best, setting)
    plan, action, _ = want.adapter.on_dynamics(best, JDynamicsEvent(t=1.0, **EVENT))
    assert out["dynamics"]["action"] == action
    same_plan(out["dynamics"]["plan"], plan, (setting, "dynamics"))
    assert f"[dynamics] adapter action={action}" in text
    assert "planning took" in text and "p99=" in text


def test_launcher_without_dynamics_reports_none():
    out = serve.main(LAUNCH)
    assert out["dynamics"] is None and out["plan"].n_stages >= 1


def test_launcher_outside_table3_raises(capsys):
    """The launcher on a catalogue scenario beyond Table 3 prints the plan
    and the reaction that the JAX package's facade gives."""
    out = serve.main(LAUNCH + ["--setting", "vehicle_platoon", "--dynamics"])
    text = capsys.readouterr().out
    want = jdora.serve("vehicle_platoon",
                       graph=jplanning_graph(jreduced_config("qwen3_32b"), 12),
                       qoe=JQoESpec(t_qoe=0.2, lam=100.0),
                       workload=JWorkload(global_batch=2, microbatch_size=1, training=False))
    best = want.report.result.best
    assert f"Dora plan: {best.summary()}" in text
    same_plan(out["plan"], best, "vehicle_platoon")
    plan, action, _ = want.adapter.on_dynamics(best, JDynamicsEvent(t=1.0, **EVENT))
    assert out["dynamics"]["action"] == action
    same_plan(out["dynamics"]["plan"], plan, ("vehicle_platoon", "dynamics"))


def test_launcher_raises_on_an_infeasible_plan():
    with pytest.raises(RuntimeError, match="no QoE-feasible plan"):
        serve.main(["--arch", "qwen3_32b", "--prompt-len", "4096", "--device", "cpu"])


def test_planner_modules_import_without_jax_or_the_jax_package():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.dora, repro_torch.runtime.pipeline, repro_torch.launch.serve\n"
            "import repro_torch.scenarios, repro_torch.strategies, repro_torch.control\n"
            "import repro_torch.sim, repro_torch.fleet, repro_torch.resilience\n"
            "repro_torch.dora.plan('vehicle_platoon')\n")
    res = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
