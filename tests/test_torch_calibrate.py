"""The port's calibration loop (``repro_torch.calibrate``) against the JAX
package's (``repro.calibrate``), on the CPU.

What is pure arithmetic is held equal: the copy of ``kernels/flops.py``
line for line; the fleet's profiles, topology and ProfiledCosts from one
fixed measurement dict field by field; for every fidelity case the proxy
graph, the fleet memory, the planned layout exactly and the layout's
latency under both cost providers to 1e-9 relative; the workload table
against the scenario catalogue; the proxy layer on the same numpy weights
at float32's 2e-5. What measures is run at a small size on the CPU (a
``Fleet("cpu", n)``): positive numbers, and no kernel launched. The
committed H100 artifacts load and plan.
"""
import dataclasses
import difflib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calibrate import fidelity as jfid
from repro.calibrate import host as jhost
from repro.calibrate import microbench as jmb
from repro.core.profiler import ProfiledCosts as JProfiledCosts
from repro.scenarios import get_scenario
from repro_torch import dora
from repro_torch.scenarios import get_scenario as tget_scenario
from repro_torch import kernels
from repro_torch.calibrate import fidelity, host, microbench, timing
from repro_torch.calibrate.timing import Fleet, MeasurementCache
from repro_torch.core.cost_model import resolve_costs
from repro_torch.core.profiler import ProfiledCosts

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
REL = 1e-9
#: A fixed measurement: every key the fleet's profiles and costs read.
MEASURE = {"matmul_peak_flops": 4.7e13, "memory_bw": 2.9e12,
           "transfer_large_bps": 1.3e12, "transfer_small_bps": 9.0e10,
           "contended_mlp_flops": 2.1e11}
CONTENDED = 1.7e11
ALL_CASES = [pytest.param(c, id=f"{'quick-' * (c in fidelity.QUICK_CASES)}{c.scenario}")
             for c in fidelity.CASES + fidelity.QUICK_CASES]
CPU4 = Fleet("cpu", 4)


def _jcase(case):
    return jfid.FidelityCase(**dataclasses.asdict(case))


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


# -- the copy ---------------------------------------------------------------------
def test_flops_is_a_verbatim_copy():
    with open(os.path.join(SRC, "repro", "kernels", "flops.py"), encoding="utf-8") as f:
        want = f.read().splitlines()
    with open(os.path.join(SRC, "repro_torch", "kernels", "flops.py"), encoding="utf-8") as f:
        got = f.read().splitlines()
    assert got[0] == "# A copy of src/repro/kernels/flops.py (the port imports nothing of " \
                     "the JAX package)."
    assert list(difflib.unified_diff(want, got[2:], lineterm="")) == []


# -- the fleet --------------------------------------------------------------------
def test_host_device_and_topology_equal_jax():
    for i in range(3):
        assert dataclasses.asdict(host.host_device(MEASURE, i, memory=2e9)) == \
            dataclasses.asdict(jhost.host_device(MEASURE, i, memory=2e9))
    for meas in (MEASURE, {k: MEASURE[k] for k in ("matmul_peak_flops", "memory_bw")}):
        got, want = host.host_topology(meas, 4), jhost.host_topology(meas, 4)
        assert [dataclasses.asdict(d) for d in got.devices] == \
            [dataclasses.asdict(d) for d in want.devices]
        assert {k: dataclasses.asdict(v) for k, v in got.resources.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.resources.items()}
    assert (host.HOSTMEM, host.HOST_MEMORY) == (jhost.HOSTMEM, jhost.HOST_MEMORY)


@pytest.mark.parametrize("contended", [None, CONTENDED])
def test_host_costs_equal_jax(contended):
    """Field by field; the provenance too, apart from the backend (torch's
    against jax's) and the date."""
    prov = {"step_ratio/qwen3_32b/train": "0.5"}
    got = host.host_costs(MEASURE, 4, contended=contended, name="n", provenance=prov,
                          fleet=CPU4)
    want = jhost.host_costs(MEASURE, 4, contended=contended, name="n", provenance=prov)
    for field in ("compute_factor", "bandwidth_factor", "default_compute",
                  "default_bandwidth", "name"):
        assert getattr(got, field) == getattr(want, field), field
    strip = lambda p: {k: v for k, v in p.items() if k not in ("backend", "date", "source")}
    assert strip(got.provenance) == strip(want.provenance)
    assert got.provenance["backend"].startswith("cpu/4/torch-")
    # the same artifact, read by the other package's loader
    assert JProfiledCosts.from_json(got.to_json()).compute_factor == want.compute_factor


# -- every fidelity case ----------------------------------------------------------
@pytest.mark.parametrize("case", ALL_CASES)
def test_proxy_graph_and_fleet_memory_equal_jax(case):
    wl = tget_scenario(case.scenario).workload
    got, want = fidelity.proxy_graph(case), jfid.proxy_graph(_jcase(case))
    assert [dataclasses.asdict(n) for n in got.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]
    assert got.total_params == want.total_params
    jwl = get_scenario(case.scenario).workload
    assert fidelity.fleet_memory(got, wl, case.n_devices) == \
        jfid.fleet_memory(want, jwl, case.n_devices)


def _planned(case):
    wl = tget_scenario(case.scenario).workload
    jwl = get_scenario(case.scenario).workload
    graph, jgraph = fidelity.proxy_graph(case), jfid.proxy_graph(_jcase(case))
    topo = host.host_topology(MEASURE, case.n_devices,
                              memory=fidelity.fleet_memory(graph, wl, case.n_devices))
    jtopo = jhost.host_topology(MEASURE, case.n_devices,
                                memory=jfid.fleet_memory(jgraph, jwl, case.n_devices))
    return (graph, topo, wl), (jgraph, jtopo, jwl)


@pytest.mark.parametrize("case", ALL_CASES)
def test_plan_layout_equals_jax(case):
    (graph, topo, wl), (jgraph, jtopo, jwl) = _planned(case)
    layout, source = fidelity.plan_layout(graph, topo, wl)
    assert (layout, source) == jfid.plan_layout(jgraph, jtopo, jwl)
    assert source == "planner" and len(layout) >= 2


@pytest.mark.parametrize("case", ALL_CASES)
def test_evaluate_layout_equals_jax(case):
    """The planned layout's latency, energy and objective, uncalibrated and
    under the costs of the fixed measurement and contended rate."""
    (graph, topo, wl), (jgraph, jtopo, jwl) = _planned(case)
    layout, _ = fidelity.plan_layout(graph, topo, wl)
    costs = host.host_costs(MEASURE, case.n_devices, contended=CONTENDED, fleet=CPU4)
    jcosts = jhost.host_costs(MEASURE, case.n_devices, contended=CONTENDED)
    for c, jc in ((None, None), (costs, jcosts)):
        got = fidelity.evaluate_layout(layout, graph, topo, wl, costs=c)
        want = jfid.evaluate_layout(layout, jgraph, jtopo, jwl, costs=jc)
        for key in ("latency", "energy", "objective"):
            _close(getattr(got, key), getattr(want, key))
    assert fidelity.evaluate_layout(layout, graph, topo, wl, costs=costs).latency > \
        fidelity.evaluate_layout(layout, graph, topo, wl).latency


def test_workload_table_equals_the_catalogue():
    """The workload each fidelity case runs is read from the port's scenario
    catalogue, as the JAX package reads its own."""
    for name in {c.scenario for c in fidelity.CASES + fidelity.QUICK_CASES}:
        assert dataclasses.asdict(tget_scenario(name).workload) == \
            dataclasses.asdict(get_scenario(name).workload), name
    assert (fidelity.CASES, fidelity.QUICK_CASES) == \
        tuple(tuple(fidelity.FidelityCase(**dataclasses.asdict(c)) for c in cases)
              for cases in (jfid.CASES, jfid.QUICK_CASES))
    assert (fidelity.SCHEMA, fidelity.GATE_FLOOR) == (jfid.SCHEMA, jfid.GATE_FLOOR)
    assert dataclasses.asdict(fidelity.LATENCY_QOE) == dataclasses.asdict(jfid.LATENCY_QOE)


def test_gated_mlp_layer_equals_jax():
    rng = np.random.default_rng(0)
    d, f, rows = 64, 256, 12
    lp = {"wg": rng.standard_normal((d, f)) * d ** -0.5,
          "wu": rng.standard_normal((d, f)) * d ** -0.5,
          "wd": rng.standard_normal((f, d)) * 1.8 * f ** -0.5}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = rng.standard_normal((rows, d)).astype(np.float32)
    got = microbench.gated_mlp_layer({k: torch.from_numpy(v) for k, v in lp.items()},
                                     torch.from_numpy(x))
    want = jmb.gated_mlp_layer({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    params = microbench.init_gated_mlp(3, d, f, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {"wg": (3, d, f), "wu": (3, d, f), "wd": (3, f, d)}


# -- the measurement cache (tests/test_calibrate.py's four) --------------------------
def test_cache_measures_once(tmp_path):
    cache = MeasurementCache(path=str(tmp_path / "m.json"), fleet=CPU4)
    calls = []

    def measure():
        calls.append(1)
        return 42.0

    assert cache.get_or_measure("bench", "shape", measure) == 42.0
    assert cache.get_or_measure("bench", "shape", measure) == 42.0
    assert len(calls) == 1
    assert (cache.hits, cache.misses) == (1, 1)


def test_cache_persists_across_instances(tmp_path):
    path = str(tmp_path / "m.json")
    MeasurementCache(path=path, fleet=CPU4).put("b", "s", 7.0)
    again = MeasurementCache(path=path, fleet=CPU4)
    assert again.lookup("b", "s") == 7.0
    assert len(again) == 1


def test_cache_in_memory_mode(tmp_path):
    cache = MeasurementCache(path=None, fleet=CPU4)
    cache.put("b", "s", 1.0)
    assert cache.lookup("b", "s") == 1.0
    assert not os.listdir(tmp_path)          # nothing written anywhere here


def test_cache_ignores_corrupt_file(tmp_path):
    path = str(tmp_path / "m.json")
    with open(path, "w", encoding="utf-8") as f:
        f.write("{not json")
    cache = MeasurementCache(path=path, fleet=CPU4)
    assert len(cache) == 0
    cache.put("b", "s", 2.0)                  # and recovers by rewriting
    assert MeasurementCache(path=path, fleet=CPU4).lookup("b", "s") == 2.0


def test_cache_keys_carry_the_fleet(tmp_path):
    path = str(tmp_path / "m.json")
    MeasurementCache(path=path, fleet=CPU4).put("b", "s", 1.0)
    other = MeasurementCache(path=path, fleet=Fleet("cpu", 2))
    assert other.lookup("b", "s") is None     # another fleet size: measured anew
    assert timing.backend_key(Fleet("cpu", 2)).startswith(f"cpu/2/torch-{torch.__version__}/")
    with pytest.raises(ValueError, match="needs a device"):
        Fleet("cpu", 0)


def test_fleet_puts_every_logical_device_on_its_device():
    assert CPU4.devices() == [torch.device("cpu")] * 4
    assert CPU4.devices(2) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("quick", [True, False])
def test_run_case_times_best_of_case_repeats(monkeypatch, quick):
    """The contended block and the executed pipeline of a case both take
    best of ``CASE_REPEATS``, which ``tools/fidelity_spread.py`` sets."""
    seen = {}

    def contended(*a, repeats, **k):
        seen["contended"] = repeats
        return 1e11

    def execute(*a, repeats, **k):
        seen["execute"] = repeats
        return 1e-2
    monkeypatch.setattr(fidelity, "CASE_REPEATS", 7)
    monkeypatch.setattr(fidelity, "contended_mlp_rate", contended)
    monkeypatch.setattr(fidelity, "execute_layout", execute)
    cache = MeasurementCache(path=None, fleet=CPU4)
    for bench, shape, v in (("matmul_peak", "d512" if quick else "d1024", 4.7e13),
                            ("memory_bw", "64MiB", 2.9e12), ("transfer", "16MiB", 1.3e12),
                            ("transfer", "64KiB", 9.0e10)):
        cache.put(bench, shape, v)
    rec = fidelity.run_case(fidelity.QUICK_CASES[0], cache, quick=quick)
    assert (seen["contended"], seen["execute"]) == (7, 7)
    assert rec["measured_s"] == 1e-2


# -- measuring on the CPU -----------------------------------------------------------
def test_kernel_rates_on_the_cpu_launch_nothing():
    before = kernels.launch_counts()
    rates = microbench.kernel_rates(repeats=1, device="cpu")
    assert kernels.launch_counts() == before
    assert set(rates) == {"flash_attention", "decode_attention", "ssd_scan", "rglru_scan"}
    assert all(v > 0 for v in rates.values())


@pytest.mark.parametrize("arch,mode", [("qwen3_32b", "train"), ("qwen3_32b", "decode"),
                                       ("mamba2_780m", "train"), ("mamba2_780m", "decode"),
                                       # the frontend stubs in the batch (frames, patches)
                                       ("whisper_small", "train"), ("whisper_small", "decode"),
                                       ("paligemma_3b", "train")])
def test_step_seconds_on_the_cpu(arch, mode):
    before = kernels.launch_counts()
    assert microbench.step_seconds(arch, mode, repeats=1, device="cpu") > 0
    assert kernels.launch_counts() == before


def test_rates_and_transfers_on_the_cpu():
    assert microbench.matmul_peak_flops(128, repeats=1, device="cpu") > 0
    assert microbench.memory_bandwidth(1 << 16, repeats=1, device="cpu") > 0
    assert microbench.transfer_goodput(1 << 12, repeats=1, fleet=CPU4) > 0
    assert microbench.contended_rate(2, dim=32, layers=2, repeats=1, fleet=CPU4) > 0
    for training in (False, True):
        assert microbench.contended_mlp_rate(2, rows=4, d_model=32, d_ff=64, layers=2,
                                             iters=2, training=training, repeats=1,
                                             fleet=CPU4) > 0
    with pytest.raises(ValueError, match=">= 2 devices"):
        microbench.transfer_goodput(1 << 12, fleet=Fleet("cpu", 1))


@pytest.mark.parametrize("name", ["smart_home_2", "vehicle_platoon"])
def test_execute_layout_on_the_cpu(name):
    case = next(c for c in fidelity.QUICK_CASES if c.scenario == name)
    case = dataclasses.replace(case, d_model=64, d_ff=128)
    wl = tget_scenario(name).workload
    before = kernels.launch_counts()
    assert fidelity.execute_layout(case, [([0, 1, 2], 0), ([3, 4, 5], 1)], wl, warmup=0,
                                   repeats=1, fleet=CPU4) > 0
    assert kernels.launch_counts() == before


def test_calibrate_on_cuda_without_a_card_raises():
    from repro_torch.calibrate.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        main(["--quick", "--cache", "none"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        microbench.kernel_rates(repeats=1)          # a CUDA card by default


def test_calibrate_cli_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.calibrate --device cpu --quick --cache none
    --devices 2`` to its end; a CPU run writes its record to the git-ignored
    ``build/calibration/cpu_fidelity.json``, never the card's."""
    artifact = tmp_path / "cpu.json"
    h100 = open(fidelity.BENCH_PATH, "rb").read()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.calibrate", "--device", "cpu", "--quick",
         "--cache", "none", "--devices", "2", "--artifact", str(artifact)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    assert "mean rel err: calibrated" in res.stdout
    assert open(fidelity.BENCH_PATH, "rb").read() == h100
    with open(fidelity.CPU_BENCH_PATH, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["schema"] == fidelity.SCHEMA
    assert set(doc["quick"]["cases"]) == {c.scenario for c in fidelity.QUICK_CASES}
    assert doc["quick"]["backend"].startswith("cpu/2/torch-")
    costs = ProfiledCosts.from_json(str(artifact))
    assert set(costs.compute_factor) == {"host0", "host1"}


# -- the committed H100 artifacts ---------------------------------------------------
def test_committed_h100_calibration_loads_and_plans():
    path = os.path.join(ROOT, "calibration", "h100.json")
    assert os.path.exists(path)
    pc = resolve_costs(f"profiled:{path}")
    assert pc.compute_factor and "H100" in pc.provenance["backend"]
    planner, _, wl = dora.planner_for("traffic_monitor", costs=f"profiled:{path}")
    profiled = planner.plan(wl).best
    analytic_planner, _, _ = dora.planner_for("traffic_monitor")
    assert profiled.n_stages >= 1 and profiled.latency > 0
    assert analytic_planner.plan(wl).best.latency > 0


def test_committed_h100_fidelity_record():
    with open(fidelity.BENCH_PATH, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["schema"] == fidelity.SCHEMA
    for section, cases in (("current", fidelity.CASES), ("quick", fidelity.QUICK_CASES)):
        cur = doc[section]
        assert set(cur["cases"]) == {c.scenario for c in cases}
        assert "H100" in cur["backend"]
        assert cur["mean_rel_err_calibrated"] < cur["mean_rel_err_uncalibrated"]
