# Mirror of tests/test_sim_baselines.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Edge simulator + baselines: validity, paper-claim directionality."""
import dataclasses
import warnings

import pytest

from repro_torch.core.cost_model import Workload
from repro_torch.core.device import make_setting
from repro_torch.core.graph_builders import paper_model
from repro_torch.core.qoe import QoESpec
from repro_torch.sim.runner import (best_baseline, compare_planners, dora_plan,
                              execute_plan, setting_and_graph, workload_for)
from repro_torch.strategies.baselines import (BaselineError, alpa_plan,
                                        asteroid_plan, edgeshard_plan,
                                        metis_plan)


def test_sim_baselines_shim_warns_deprecation():
    """The legacy module still resolves, but tells you where to go."""
    import repro_torch.sim.baselines as shim
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn = shim.alpa_plan
    assert fn is alpa_plan
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert any("repro_torch.strategies.baselines" in str(w.message) for w in caught)
    with pytest.raises(AttributeError):
        shim.nonexistent_name

LAT = QoESpec(t_qoe=0.0, lam=1e15)


@pytest.fixture(scope="module")
def sh2():
    return setting_and_graph("smart_home_2", "qwen3-0.6b", "train")


def _covers(plan, graph):
    covered = sorted(i for s in plan.stages for i in s.node_ids)
    return covered == list(range(len(plan.meta["graph"].nodes)))


def test_baselines_produce_valid_plans(sh2):
    topo, graph = sh2
    wl = workload_for("train")
    for fn in (asteroid_plan, alpa_plan, metis_plan, edgeshard_plan):
        plan = fn(graph, topo, wl)
        assert plan.stages
        assert _covers(plan, graph)
        assert plan.latency > 0


def test_alpa_uses_uniform_split(sh2):
    topo, graph = sh2
    plan = alpa_plan(graph, topo, workload_for("train"))
    for s in plan.stages:
        if s.dp_degree > 1:
            fracs = list(s.microbatch_split.values())
            assert max(fracs) == pytest.approx(min(fracs))


def test_edgeshard_oom_under_full_adam(sh2):
    """With full fp32 Adam state (8× params), EdgeShard's even split
    overloads the small devices — the paper's reported failure mode."""
    topo, _ = sh2
    graph = paper_model("qwen3-1.7b", seq_len=512)
    wl = Workload(global_batch=32, microbatch_size=4, optimizer_mult=8.0)
    with pytest.raises(BaselineError):
        edgeshard_plan(graph, topo, wl)


def test_dora_never_loses_to_baselines(sh2):
    topo, graph = sh2
    res = compare_planners(graph, topo, workload_for("train"))
    assert res["dora"].ok
    name, bb = best_baseline(res)
    assert res["dora"].latency <= bb.latency * 1.001


def test_dora_beats_baselines_on_inference():
    topo, graph = setting_and_graph("smart_home_2", "qwen3-1.7b", "infer")
    res = compare_planners(graph, topo, workload_for("infer"))
    name, bb = best_baseline(res)
    assert res["dora"].ok
    assert bb.latency / res["dora"].latency >= 1.2   # paper: 1.2–2.8×


def test_energy_savings_under_qoe(sh2):
    """Fig. 10/11 logic: given latency slack (T_QoE = 1.25× of the
    latency-optimal plan), the QoE-aware objective finds a plan that
    meets the target with less energy."""
    topo, graph = sh2
    wl = workload_for("train")
    fast = dora_plan(graph, topo, LAT, wl).best
    qoe = QoESpec(t_qoe=fast.latency * 1.5, lam=1e6)
    saver = dora_plan(graph, topo, qoe, wl).best
    assert saver.latency <= qoe.t_qoe * 1.05
    assert saver.energy < fast.energy * 0.92, \
        f"expected ≥8% energy saving, got {saver.energy/fast.energy:.3f}"


def test_plan_switch_scheduled_vs_fair(sh2):
    """Dora's Phase-2 chunked schedule never loses to fluid sharing."""
    topo, graph = sh2
    wl = workload_for("train")
    plan = asteroid_plan(graph, topo, wl)
    fair = execute_plan(plan, topo, LAT, scheduled=False)
    sched = execute_plan(plan, topo, LAT, scheduled=True)
    assert sched.latency <= fair.latency * (1 + 1e-9)
