# Mirror of tests/test_serving_kernel.py on the port: the same tests, with repro read as
# repro_torch; imports nothing of jax or of the JAX package.
"""The shared serving kernel (``repro_torch.core.events``).

Three layers of protection around the vectorized refactor:

* **Golden parity** — ``tests/golden/serving_golden.json`` was generated
  by the *pre-refactor per-request loop*; the vectorized kernel must
  reproduce its p50/p95/p99, SLO attainment, failed counts and
  per-device energy to 1e-9 relative on catalog scenarios and a fleet.
* **Segmentation invariance** — chunk size 1 degenerates to the old
  per-request recurrence bit-for-bit, so running churn-heavy scenarios
  at chunk ∈ {1, 7, None} and asserting identical traces proves the
  closed-form Lindley segments equal discrete stepping on the paths
  the goldens can't lock (replans, stalls, degraded requests).
* **Unit coverage** — the arrival-process zoo, multi-class SLO tiers,
  presence/ownership energy attribution, the array-backed request log
  and the deprecation shims over moved internals.
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings

import numpy as np
import pytest

from repro_torch.core.adapter import DynamicsEvent
from repro_torch.core.events import (ActivePlan, DiurnalArrivals,
                               FlashCrowdArrivals, MMPPArrivals,
                               OwnershipTracker, PoissonArrivals,
                               PresenceTracker, RequestClass, RequestLog,
                               RequestRecord, ServingLoad, ServingTrace,
                               Stream, TraceArrivals, assign_classes,
                               interactive_batch, overlap_seconds,
                               poisson_arrivals)
from repro_torch.sim.fleet import simulate_fleet
from repro_torch.sim.serving import simulate_requests
from torch_parity import use_clock

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "serving_golden.json")

with open(GOLDEN, encoding="utf-8") as f:
    GOLDEN_DOC = json.load(f)


def assert_close(got, want, what, tol=1e-9):
    if isinstance(want, float) and (math.isinf(want) or math.isnan(want)):
        assert got == want, what
        return
    assert abs(got - want) <= tol * max(1.0, abs(got), abs(want)), \
        f"{what}: got {got!r}, golden {want!r}"


# -- golden parity with the pre-refactor per-request loop ----------------------
@pytest.mark.parametrize("key", sorted(GOLDEN_DOC["cases"]))
def test_golden_serving_parity(key):
    case = GOLDEN_DOC["cases"][key]
    ld = case["load"]
    tr = simulate_requests(case["scenario"], strategy=case["strategy"],
                           load=ServingLoad(rate=ld["rate"],
                                            n_requests=ld["n_requests"],
                                            seed=ld["seed"]))
    g = case["trace"]
    assert len(tr.requests) == g["n_requests"]
    assert tr.n_failed == g["n_failed"]
    for what in ("p50", "p95", "p99"):
        assert_close(getattr(tr, what), g[what], f"{key}.{what}")
    assert_close(tr.mean_latency, g["mean"], f"{key}.mean")
    assert_close(tr.slo_attainment, g["slo_attainment"], f"{key}.slo")
    assert_close(tr.energy, g["energy_j"], f"{key}.energy")
    assert_close(tr.horizon_s, g["horizon_s"], f"{key}.horizon")
    for d, e in g["per_device_energy_j"].items():
        assert_close(tr.per_device_energy[int(d)], e, f"{key}.E[{d}]")
    for d, b in g["per_device_busy_s"].items():
        assert_close(tr.per_device_busy[int(d)], b, f"{key}.busy[{d}]")
    assert [[a.t, a.action] for a in tr.actions] == g["actions"]


@pytest.mark.parametrize("fleet", sorted(GOLDEN_DOC["fleet"]))
def test_golden_fleet_parity(fleet):
    case = GOLDEN_DOC["fleet"][fleet]
    tload = {k: ServingLoad(rate=v["rate"], n_requests=v["n_requests"],
                            seed=v["seed"])
             for k, v in case["loads"].items()}
    ftr = simulate_fleet(fleet, loads=tload, span_s=case["span_s"],
                         seed=case["seed"])
    assert ftr.rebalances == case["rebalances"]
    assert_close(ftr.energy, case["energy_j"], f"{fleet}.energy")
    assert_close(ftr.horizon_s, case["horizon_s"], f"{fleet}.horizon")
    assert {k: list(v) for k, v in sorted(ftr.assignments.items())} \
        == case["assignments"]
    for d, e in case["per_device_energy_j"].items():
        assert_close(ftr.per_device_energy[int(d)], e, f"{fleet}.E[{d}]")
    for tname, g in case["tenants"].items():
        t = ftr.tenants[tname]
        assert len(t.requests) == g["n_requests"]
        for what in ("p50", "p95", "p99"):
            assert_close(getattr(t, what), g[what], f"{tname}.{what}")
        assert_close(t.slo_attainment, g["slo_attainment"], f"{tname}.slo")
        assert_close(t.energy, g["energy_j"], f"{tname}.energy")
        for d, e in g["per_device_energy_j"].items():
            assert_close(t.per_device_energy[int(d)], e, f"{tname}.E[{d}]")
        assert [[a.t, a.action] for a in t.actions] == g["actions"]


# -- segmentation invariance: chunking never changes results -------------------
def _trace_vector(tr):
    return (np.asarray(tr.requests.start), np.asarray(tr.requests.finish),
            tr.slo_attainment, tr.n_failed, tr.energy, tr.horizon_s,
            dict(tr.per_device_energy), dict(tr.per_device_busy))


def _assert_same_trace(a, b, what):
    sa, fa, *ra = a
    sb, fb, *rb = b
    assert np.allclose(sa, sb, rtol=1e-9, atol=1e-9), f"{what}: starts"
    assert np.allclose(fa, fb, rtol=1e-9, atol=1e-9, equal_nan=True) \
        or np.array_equal(np.isinf(fa), np.isinf(fb)) \
        and np.allclose(fa[np.isfinite(fa)], fb[np.isfinite(fb)],
                        rtol=1e-9, atol=1e-9), f"{what}: finishes"
    (slo_a, nf_a, e_a, h_a, pde_a, pdb_a) = ra
    (slo_b, nf_b, e_b, h_b, pde_b, pdb_b) = rb
    assert nf_a == nf_b, what
    assert_close(slo_a, slo_b, f"{what}: slo")
    assert_close(e_a, e_b, f"{what}: energy")
    assert_close(h_a, h_b, f"{what}: horizon")
    assert pde_a.keys() == pde_b.keys(), what
    for d in pde_a:
        assert_close(pde_a[d], pde_b[d], f"{what}: E[{d}]")
    for d in pdb_a:
        assert_close(pdb_a[d], pdb_b[d], f"{what}: busy[{d}]")


@pytest.mark.parametrize("scenario,strategy", [
    ("traffic_monitor", "dora"),        # leave/join churn + replans
    ("smart_home_2", "dora"),           # churn + bandwidth dynamics + stall
    ("smart_home_2", "chain_split"),    # static path incl. degraded requests
])
def test_chunk_size_never_changes_serving_results(scenario, strategy):
    """chunk=1 IS the historical per-request loop; larger chunks and the
    unchunked closed form must produce the same trace through replans,
    migration stalls and degraded (churn-broken) segments."""
    load = ServingLoad(rate=3.0, n_requests=300, seed=11)
    ref = _trace_vector(simulate_requests(scenario, strategy=strategy,
                                          load=load, chunk=1))
    for chunk in (7, 64, None):
        got = _trace_vector(simulate_requests(scenario, strategy=strategy,
                                              load=load, chunk=chunk))
        _assert_same_trace(got, ref, f"{scenario}/{strategy} chunk={chunk}")


def test_chunk_size_never_changes_fleet_results():
    ref = None
    for chunk in (1, 13, None):
        ftr = simulate_fleet("traffic_intersection", span_s=90.0,
                             seed=3, chunk=chunk)
        vec = {name: _trace_vector(t) for name, t in ftr.tenants.items()}
        if ref is None:
            ref = (vec, ftr.energy, ftr.rebalances)
            continue
        assert ftr.rebalances == ref[2]
        assert_close(ftr.energy, ref[1], f"fleet energy chunk={chunk}")
        for name in ref[0]:
            _assert_same_trace(vec[name], ref[0][name],
                               f"{name} chunk={chunk}")


def test_stream_rejects_bad_chunk():
    with pytest.raises(ValueError):
        Stream(np.asarray([1.0]), chunk=0)


# -- the Lindley recurrence against a hand-rolled discrete loop ----------------
def test_stream_matches_discrete_queue_recurrence():
    rng = np.random.default_rng(5)
    arr = np.cumsum(rng.exponential(0.4, size=500))
    plan = ActivePlan(latency=1.0, interval=0.5, per_device_energy={0: 2.0},
                      non_idle_energy={0: 1.5}, compute_busy={0: 0.25},
                      devices=(0,))
    s = Stream(arr, plan=plan)
    s.drain()
    _, starts, finishes = s.arrays()
    nf = 0.0
    for i, a in enumerate(arr):
        start = max(float(a), nf)
        assert abs(starts[i] - start) < 1e-9, i
        assert abs(finishes[i] - (start + 1.0)) < 1e-9, i
        nf = start + 0.5
    assert s.service_energy[0] == pytest.approx(500 * 1.5)
    assert s.busy[0] == pytest.approx(500 * 0.25)


def test_stream_degraded_segments_fail_without_consuming_capacity():
    arr = np.asarray([1.0, 2.0, 3.0, 4.0])
    plan = ActivePlan(latency=0.5, interval=0.5, per_device_energy={},
                      non_idle_energy={}, compute_busy={}, devices=(0,))
    s = Stream(arr, plan=plan)
    s.serve_to(2.5)                 # serves 1.0, 2.0
    s.alive = False
    s.serve_to(3.5)                 # 3.0 fails
    s.alive = True
    s.drain()                       # 4.0 served again
    _, starts, finishes = s.arrays()
    assert math.isinf(finishes[2]) and not math.isinf(finishes[3])
    # the failed request did not advance the queue: 4.0 starts on time
    assert starts[3] == pytest.approx(4.0)


# -- arrival-process zoo -------------------------------------------------------
def test_poisson_process_matches_module_function():
    a = PoissonArrivals().sample(2.5, 400, seed=9)
    b = poisson_arrivals(2.5, 400, seed=9)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("proc", [
    PoissonArrivals(),
    DiurnalArrivals(period_s=120.0, amplitude=0.9),
    MMPPArrivals(multipliers=(0.2, 5.0), mean_sojourn_s=(40.0, 8.0)),
    FlashCrowdArrivals(peak_multiplier=6.0, t_start=20.0, ramp_s=5.0,
                       hold_s=30.0),
])
def test_arrival_processes_deterministic_sorted_nonnegative(proc):
    a = proc.sample(3.0, 1000, seed=4)
    b = proc.sample(3.0, 1000, seed=4)
    c = proc.sample(3.0, 1000, seed=5)
    assert np.array_equal(a, b)                    # deterministic per seed
    assert not np.array_equal(a, c)                # seed actually matters
    assert len(a) == 1000
    assert a[0] >= 0.0 and np.all(np.diff(a) >= 0.0)


def test_diurnal_mean_rate_and_modulation():
    proc = DiurnalArrivals(period_s=100.0, amplitude=0.9, phase_s=0.0)
    a = proc.sample(10.0, 20_000, seed=1)
    # long-run mean rate ≈ the load's rate
    assert a[-1] == pytest.approx(20_000 / 10.0, rel=0.1)
    # peak quarter-period (sin > 0.7) must far out-arrive the trough
    phase = (a % 100.0) / 100.0
    peak = np.count_nonzero((phase > 0.125) & (phase < 0.375))
    trough = np.count_nonzero((phase > 0.625) & (phase < 0.875))
    assert peak > 3 * trough


def test_mmpp_is_burstier_than_poisson():
    """Index of dispersion of per-window counts: ~1 for Poisson, >> 1
    for a Markov-modulated process."""
    def dispersion(arr, w=10.0):
        counts = np.bincount((arr / w).astype(int))
        return counts.var() / max(counts.mean(), 1e-12)
    mmpp = MMPPArrivals(multipliers=(0.1, 6.0), mean_sojourn_s=(60.0, 15.0))
    a = mmpp.sample(4.0, 20_000, seed=7)
    p = PoissonArrivals().sample(4.0, 20_000, seed=7)
    assert dispersion(a) > 3.0 * dispersion(p)


def test_flash_crowd_concentrates_arrivals_in_the_window():
    proc = FlashCrowdArrivals(peak_multiplier=10.0, t_start=50.0,
                              ramp_s=5.0, hold_s=40.0)
    a = proc.sample(1.0, 4000, seed=2)
    in_window = np.count_nonzero((a >= 50.0) & (a <= 100.0))
    before = np.count_nonzero(a < 50.0)
    # 50 s of baseline ≈ 50 arrivals; 50 s around the 10x peak ≈ 450
    assert in_window > 5 * before


def test_trace_arrivals_passthrough_and_truncation():
    t = TraceArrivals(times=(5.0, 1.0, 3.0, 9.0))
    assert np.array_equal(t.sample(123.0, 10, seed=0), [1.0, 3.0, 5.0, 9.0])
    assert np.array_equal(t.sample(123.0, 2, seed=0), [1.0, 3.0])
    with pytest.raises(ValueError):
        TraceArrivals(times=(-1.0, 2.0)).sample(1.0, 5)


@pytest.mark.parametrize("bad", [
    lambda: poisson_arrivals(0.0, 10),
    lambda: poisson_arrivals(2.0, 0),
    lambda: DiurnalArrivals(amplitude=1.5),
    lambda: DiurnalArrivals(period_s=0.0),
    lambda: MMPPArrivals(multipliers=(1.0,)),
    lambda: MMPPArrivals(mean_sojourn_s=(1.0, 0.0)),
    lambda: FlashCrowdArrivals(peak_multiplier=0.5),
])
def test_arrival_validation(bad):
    with pytest.raises(ValueError):
        bad()


# -- multi-class SLO tiers -----------------------------------------------------
def test_assign_classes_weighted_and_deterministic():
    classes = (RequestClass("a", weight=3.0), RequestClass("b", weight=1.0))
    ids = assign_classes(40_000, classes, seed=1)
    assert np.array_equal(ids, assign_classes(40_000, classes, seed=1))
    share = np.count_nonzero(ids == 0) / len(ids)
    assert share == pytest.approx(0.75, abs=0.02)


def test_multiclass_slo_tiers_judged_separately():
    load = ServingLoad(rate=6.0, n_requests=400, seed=3,
                       classes=interactive_batch(0.05, 10.0,
                                                 interactive_share=0.5))
    tr = simulate_requests("hospital_ward", load=load)
    cm = tr.class_metrics()
    assert set(cm) == {"interactive", "batch"}
    assert cm["interactive"]["n"] + cm["batch"]["n"] == 400
    # the lax batch tier must attain at least as well as the 50 ms tier
    assert cm["batch"]["slo_attainment"] >= cm["interactive"]["slo_attainment"]
    # blended attainment is the class-weighted mix, not the base-SLO one
    blended = sum(cm[c]["slo_attainment"] * cm[c]["n"] for c in cm) / 400
    assert tr.slo_attainment == pytest.approx(blended)
    assert "classes" in tr.to_dict()


def test_single_class_load_matches_classless_load():
    """One class with no SLO override is the degenerate case: identical
    arrivals, latencies and attainment as the classless default."""
    plain = simulate_requests(
        "hospital_ward", load=ServingLoad(rate=5.0, n_requests=200, seed=2))
    tiered = simulate_requests(
        "hospital_ward", load=ServingLoad(rate=5.0, n_requests=200, seed=2,
                                          classes=(RequestClass("all"),)))
    assert np.array_equal(plain.requests.arrival, tiered.requests.arrival)
    assert np.array_equal(plain.requests.finish, tiered.requests.finish)
    assert plain.slo_attainment == tiered.slo_attainment


def test_request_class_validation():
    with pytest.raises(ValueError):
        RequestClass("bad", weight=0.0)
    with pytest.raises(ValueError):
        interactive_batch(0.1, 1.0, interactive_share=1.0)


# -- the array-backed request log ----------------------------------------------
def test_request_log_sequence_protocol():
    log = RequestLog([0.0, 1.0, 2.0], [0.0, 1.5, 3.0], [1.0, 2.5, math.inf])
    assert len(log) == 3
    assert isinstance(log[0], RequestRecord)
    assert log[0].latency == pytest.approx(1.0)
    assert log[1].waiting == pytest.approx(0.5)
    assert log[-1].served is False
    assert [r.arrival for r in log] == [0.0, 1.0, 2.0]
    assert len(log[1:]) == 2 and isinstance(log[1:], RequestLog)
    with pytest.raises(IndexError):
        log[3]
    with pytest.raises(ValueError):
        RequestLog([0.0], [0.0, 1.0], [1.0])


def test_serving_trace_accepts_record_lists():
    """Back-compat: tests and callers that hand-build traces from
    ``RequestRecord`` lists keep working (converted to a RequestLog)."""
    tr = ServingTrace(scenario="x", strategy="s",
                      load=ServingLoad(rate=1.0), slo_s=1.0,
                      requests=[RequestRecord(0.0, 0.0, 0.5),
                                RequestRecord(1.0, 1.0, math.inf)],
                      actions=[], per_device_energy={}, per_device_busy={},
                      horizon_s=2.0)
    assert isinstance(tr.requests, RequestLog)
    assert tr.n_failed == 1
    assert tr.p50 == pytest.approx(math.inf)


# -- presence & ownership attribution ------------------------------------------
def test_presence_tracker_bills_only_presence_intervals():
    p = PresenceTracker(3)
    p.apply(DynamicsEvent(t=10.0, leave=(1,)))
    p.apply(DynamicsEvent(t=30.0, join=(1,)))
    p.apply(DynamicsEvent(t=40.0, leave=(2,)))
    p.apply(DynamicsEvent(t=45.0, leave=(2,)))      # double-leave: no-op
    p.apply(DynamicsEvent(t=50.0, join=(7,)))       # unknown device: no-op
    secs = p.seconds(100.0)
    assert secs[0] == pytest.approx(100.0)
    assert secs[1] == pytest.approx(10.0 + 70.0)
    assert secs[2] == pytest.approx(40.0)
    assert p.intervals(100.0)[1] == [(0.0, 10.0), (30.0, 100.0)]


def test_ownership_tracker_prorates_spans():
    o = OwnershipTracker({"a": (0, 1), "b": (2,)})
    o.update(40.0, {"a": (0,), "b": (1, 2)})        # device 1 changes hands
    o.update(60.0, {"a": (0,), "b": (1, 2)})        # no change: coalesced
    spans = o.spans(100.0)
    assert spans[0] == [(0.0, 100.0, "a")]
    assert spans[1] == [(0.0, 40.0, "a"), (40.0, 100.0, "b")]
    assert spans[2] == [(0.0, 100.0, "b")]
    assert len(o.history) == 2


def test_overlap_seconds():
    iv = [(0.0, 10.0), (20.0, 30.0)]
    assert overlap_seconds(iv, 5.0, 25.0) == pytest.approx(10.0)
    assert overlap_seconds(iv, 12.0, 18.0) == 0.0


# -- deprecation shims over moved internals ------------------------------------
@pytest.mark.parametrize("name,target", [
    ("poisson_arrivals", "poisson_arrivals"),
    ("normalize_timeline", "normalize_timeline"),
    ("_ActivePlan", "ActivePlan"),
    ("_freeze", "freeze_plan"),
    ("_service_interval", "service_interval"),
])
def test_moved_internals_warn_but_resolve(name, target):
    import repro_torch.core.events as kernel
    import repro_torch.sim.serving as serving
    with pytest.warns(DeprecationWarning, match="moved to"):
        obj = getattr(serving, name)
    assert obj is getattr(kernel, target)


def test_unknown_serving_attribute_still_raises():
    import repro_torch.sim.serving as serving
    with pytest.raises(AttributeError):
        serving.no_such_thing  # noqa: B018


def test_public_serving_api_warning_free():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from repro_torch.sim.serving import (AdapterAction, RequestRecord,  # noqa: F401,F811
                                       ServingLoad, ServingTrace,
                                       default_load, simulate_requests)
        from repro_torch.sim import poisson_arrivals  # noqa: F401,F811


# -- scale: the whole point of the vectorized kernel ---------------------------
@pytest.mark.parametrize("n", [100_000])
def test_hundred_thousand_requests_in_seconds(n, monkeypatch):
    """A 10^5-request trace must simulate in single-digit seconds — a
    canary against accidental per-request Python fallbacks (the full
    10^4/10^5/10^6 trajectory lives in BENCH_serving.json). The simulator
    reads a deterministic clock (torch_parity), so a rerun gives the same
    trace; this test's own timer is the real one."""
    from repro_torch import dora
    session = dora.serve("traffic_monitor")
    clock = use_clock(monkeypatch, "repro_torch")
    load = ServingLoad(rate=50.0, n_requests=n, seed=0)
    t0 = time.perf_counter()
    tr = simulate_requests("traffic_monitor", session=session, load=load,
                           events=())
    dt = time.perf_counter() - t0
    assert len(tr.requests) == n
    assert dt < 10.0, f"10^5 requests took {dt:.1f}s — vectorization broke"
    clock.reset()
    again = simulate_requests("traffic_monitor", session=session, load=load,
                              events=())
    assert again.to_dict() == tr.to_dict()
    np.testing.assert_array_equal(again.requests.finish, tr.requests.finish)
