# Mirror of tests/test_scenario_properties.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""Property-based stress suite over the generated scenario distribution.

The hand-wired catalog exercises the planner on ~a dozen points of the
deployment space; ``repro_torch.scenarios.generate`` samples that space, and
this module asserts the planner's invariants hold across the *sampled
distribution* — hundreds of deployments per run, not nine:

1. every feasible generated scenario produces a plan;
2. QoE verdicts are monotone in the t_qoe/e_qoe budgets;
3. ``Topology.subset`` routing never crosses tenant allotments;
4. generation and plan objectives are deterministic per seed
   (summaries additionally locked by ``golden/scenario_gen_golden.json``);
5. every registered strategy returns a well-formed plan or a clean
   infeasibility.

Runs under real hypothesis when installed, otherwise under the
deterministic multi-example stand-in (``helpers/_hypothesis_compat``).
Example budgets honor ``STRESS_EXAMPLES`` (e.g. ``STRESS_EXAMPLES=500``
for a nightly-style deep sweep); the fast defaults keep the whole
module in tier-1 time while still sampling 100+ scenarios.
"""
import json
import os

import pytest

from helpers._hypothesis_compat import given, max_examples, settings, st
from repro_torch import dora
from repro_torch.core.partitioner import PartitionerConfig
from repro_torch.core.qoe import QoESpec
from repro_torch.scenarios import list_scenarios
from repro_torch.scenarios.generate import (FAMILIES, TOPOLOGY_FAMILIES, generate,
                                      generate_fleet, list_families,
                                      sample_params, summarize)
from repro_torch.strategies import StrategyError, get_strategy, list_strategies

FAST_DORA = PartitionerConfig(top_k=2)
#: strategy params that keep exhaustive planners inside property budgets
FAST_PARAMS = {
    "dora": dict(partitioner_config=FAST_DORA),
    "brute_force": dict(shortlist=4, max_stages=3),
}

families = st.sampled_from(list_families())
seeds = st.integers(min_value=0, max_value=4999)


def _well_formed(plan, topo, graph):
    """A plan is well-formed iff its stages tile the graph onto devices
    that exist, with positive objective terms."""
    assert plan.latency > 0.0
    assert plan.energy > 0.0
    devices = {d for s in plan.stages for d in s.devices}
    assert devices <= set(range(topo.n))
    covered = sorted(i for s in plan.stages for i in s.node_ids)
    assert covered == sorted(set(covered))       # no node planned twice


# -- invariant 1: feasible scenarios plan -----------------------------------------
@settings(max_examples=max_examples(30), deadline=None)
@given(families, seeds)
def test_prop_generated_scenarios_produce_plans(family, seed):
    """Every generated scenario is feasible by construction (the
    sampler sizes models to the fleet's memory and anchors t_qoe on an
    ideal-latency floor) — so planning must always succeed."""
    sc = generate(family, seed)
    report = dora.plan(sc, partitioner_config=FAST_DORA)
    _well_formed(report.best, report.topology, report.graph)
    assert report.pareto, sc.name


# -- invariant 2: QoE verdicts monotone in budgets --------------------------------
@settings(max_examples=max_examples(25), deadline=None)
@given(families, seeds,
       st.floats(min_value=0.05, max_value=4.0),
       st.floats(min_value=0.05, max_value=4.0))
def test_prop_qoe_verdict_monotone_in_budgets(family, seed, f_a, f_b):
    """Relaxing t_qoe/e_qoe can only flip a verdict unsat -> sat, never
    the other way: QoESpec.satisfied is monotone in its budgets."""
    sc = generate(family, seed, model="tiny_lm_4", seq_len=64)
    plan = dora.plan(sc, partitioner_config=FAST_DORA).best
    lo, hi = sorted((f_a, f_b))
    e_base = sc.qoe.e_qoe if sc.qoe.e_qoe is not None else plan.energy
    tight = QoESpec(t_qoe=sc.qoe.t_qoe * lo, e_qoe=e_base * lo,
                    lam=sc.qoe.lam)
    loose = QoESpec(t_qoe=sc.qoe.t_qoe * hi, e_qoe=e_base * hi,
                    lam=sc.qoe.lam)
    if tight.satisfied(plan):
        assert loose.satisfied(plan), (sc.name, lo, hi)
    # and the fully-relaxed budget always accepts
    assert QoESpec(t_qoe=float("inf"), lam=sc.qoe.lam).satisfied(plan)


# -- invariant 3: subset routing stays inside the allotment -----------------------
@settings(max_examples=max_examples(40), deadline=None)
@given(families, seeds, st.integers(min_value=0, max_value=63))
def test_prop_subset_routes_stay_inside_allotment(family, seed, drop):
    """Dropping any one device either raises a clean disconnection
    error (partial meshes / line interiors) or yields a subset whose
    every route and link-membership set stays inside the kept devices —
    tenants never transfer over each other's hardware."""
    topo = generate(family, seed).build_topology()
    keep = [i for i in range(topo.n) if i != drop % topo.n]
    try:
        sub, mapping = topo.subset(keep)
    except ValueError as e:
        assert "disconnect" in str(e)
        return
    assert sub.n == len(keep)
    assert sorted(mapping) == keep
    own = set(range(sub.n))
    for i in own:
        for j in own:
            if i != j:
                for r in sub.resources_between(i, j):
                    assert r.members <= own, (keep, i, j, r.name)
    # kept devices preserve identity through the mapping
    for old, new in mapping.items():
        assert sub.devices[new].name == topo.devices[old].name


# -- invariant 4: deterministic per seed ------------------------------------------
@settings(max_examples=max_examples(50), deadline=None)
@given(families, seeds)
def test_prop_generation_deterministic_per_seed(family, seed):
    """Same (family, seed) -> byte-identical parameter summary and
    bit-identical plan objectives on independent runs."""
    a, b = sample_params(family, seed), sample_params(family, seed)
    assert a.summary() == b.summary()
    sc_a = generate(family, seed, model="tiny_lm_4", seq_len=64)
    sc_b = generate(family, seed, model="tiny_lm_4", seq_len=64)
    plan_a = dora.plan(sc_a, partitioner_config=FAST_DORA).best
    plan_b = dora.plan(sc_b, partitioner_config=FAST_DORA).best
    assert plan_a.latency == plan_b.latency
    assert plan_a.energy == plan_b.energy
    assert plan_a.objective == plan_b.objective


# -- invariant 5: every strategy well-formed or cleanly infeasible ----------------
@settings(max_examples=max_examples(25), deadline=None)
@given(families, seeds, st.sampled_from(sorted(list_strategies())))
def test_prop_every_strategy_well_formed_or_clean(family, seed, strategy):
    """Any registered strategy on any generated scenario either returns
    a well-formed plan or raises StrategyError / the planner's
    documented no-feasible-plan RuntimeError — never garbage."""
    sc = generate(family, seed, model="tiny_lm_4", seq_len=64)
    topo, graph = sc.build_topology(), sc.build_graph()
    strat = get_strategy(strategy, **FAST_PARAMS.get(strategy, {}))
    try:
        result = strat.plan(graph, topo, sc.qoe, sc.workload)
    except StrategyError:
        return                                   # clean infeasibility
    except RuntimeError as e:
        assert "no QoE-feasible plan" in str(e)
        return
    _well_formed(result.best, topo, graph)
    assert result.pareto


# -- coverage: the generator spans the space --------------------------------------
def test_generator_produces_200_distinct_scenarios():
    """Acceptance floor: >= 200 distinct valid scenarios across >= 4
    topology families (names and summaries both distinct)."""
    summaries, names, topos = set(), set(), set()
    for family in list_families():
        for seed in range(50):
            p = sample_params(family, seed)
            summaries.add(p.summary())
            names.add(p.name)
            topos.add(p.topology_family)
    assert len(summaries) >= 200
    assert len(names) >= 200
    assert len(topos) >= 4
    assert set(topos) <= set(TOPOLOGY_FAMILIES)


def test_generated_families_cover_all_archetypes():
    assert {"edge_sites", "smart_home", "vehicle_platoon",
            "lossy_mesh"} <= set(FAMILIES)
    for name, spec in FAMILIES.items():
        assert spec.topologies, name
        assert spec.device_classes, name
        assert spec.n_devices[0] >= 2, name


def test_generated_representatives_registered():
    """The catalog pins one named representative per new family."""
    names = set(list_scenarios(tag="generated"))
    assert {"platoon_convoy", "lossy_mesh"} <= names
    from repro_torch.fleet import list_fleets, resolve_fleet
    assert "mixed_train_serve" in list_fleets()
    fs = resolve_fleet("mixed_train_serve")
    assert "generated" in fs.tags
    assert len(fs.tenants) >= 2


def test_generate_rejects_unknown_overrides():
    with pytest.raises(TypeError, match="unknown ScenarioParams"):
        generate("edge_sites", 0, nonsense=1)
    with pytest.raises(KeyError, match="edge_sites"):
        sample_params("no_such_family", 0)


def test_generate_fleet_deterministic_and_coplannable():
    a, b = generate_fleet(3), generate_fleet(3)
    assert a.name == b.name == "gen/mixed_train_serve/0003"
    assert [t.name for t in a.tenants] == [t.name for t in b.tenants]
    assert [t.qoe.t_qoe for t in a.tenants] == [t.qoe.t_qoe
                                                for t in b.tenants]
    plan = dora.plan_fleet(a)
    assert plan.feasible
    allotted = [d for t in plan.tenants for d in plan.tenant(t).allotment]
    assert sorted(allotted) == sorted(set(allotted))


# -- golden: generation is byte-stable --------------------------------------------
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "scenario_gen_golden.json")


def test_golden_scenario_summaries():
    """Same seed -> byte-identical summary, locked against the checked-in
    golden file (regenerate with tests/golden/gen_scenario_golden.py
    only when a PR intentionally changes the sampling distributions)."""
    with open(GOLDEN_PATH, encoding="utf-8") as f:
        golden = json.load(f)
    assert set(golden["families"]) == set(list_families())
    mismatches = []
    for family, rows in golden["summaries"].items():
        for seed_str, expected in rows.items():
            got = summarize((family, int(seed_str)))
            if got != expected:
                mismatches.append((family, seed_str, expected, got))
    assert not mismatches, mismatches[:3]
    n = sum(len(rows) for rows in golden["summaries"].values())
    assert n >= 40
