# A copy of src/repro/scenarios/__main__.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port must plan the reference's deployments, field for field.
"""Scenario sweep CLI.

    PYTHONPATH=src python -m repro_torch.scenarios --list
    PYTHONPATH=src python -m repro_torch.scenarios --strategies
    PYTHONPATH=src python -m repro_torch.scenarios --run smart_home_2
    PYTHONPATH=src python -m repro_torch.scenarios --run all [--simulate]
    PYTHONPATH=src python -m repro_torch.scenarios --run traffic_monitor --requests
    PYTHONPATH=src python -m repro_torch.scenarios --run smart_home_2 \
        --strategy chain_split
    PYTHONPATH=src python -m repro_torch.scenarios --run smart_home_2 \
        --compare dora throughput_max chain_split --json out.json

``--list`` prints the scenario registry; ``--strategies`` the planner
registry; ``--run`` plans the named scenario(s) through the
``repro_torch.dora`` facade and prints each PlanReport; ``--strategy`` swaps
the planner; ``--compare`` runs several strategies side by side;
``--simulate`` additionally replays each scenario's registered dynamics
timeline through the runtime adapter; ``--requests`` runs the
request-level serving simulator (open-loop arrivals at the scenario's
registered rate, timeline + churn included) and reports p50/p95/p99
latency, SLO attainment and energy; ``--json PATH`` writes everything
the run produced as one machine-readable artifact.

``--fleet`` switches both ``--list`` and ``--run`` to the multi-tenant
fleet registry (``repro_torch.fleet``)::

    PYTHONPATH=src python -m repro_torch.scenarios --list --fleet
    PYTHONPATH=src python -m repro_torch.scenarios --run smart_home_assist --fleet
    PYTHONPATH=src python -m repro_torch.scenarios --run all --fleet --requests

``--run NAME --fleet`` co-plans the fleet (``dora.plan_fleet``) and
prints every tenant's allotment + QoE verdict; ``--requests`` then runs
the multi-tenant serving simulator on the fleet timeline.

``--generate`` samples from the seeded generator families
(``repro_torch.scenarios.generate``) instead of the registry::

    PYTHONPATH=src python -m repro_torch.scenarios --generate lossy_mesh \
        --seed 0 --count 5
    PYTHONPATH=src python -m repro_torch.scenarios --generate all --count 3

Each sampled deployment prints its canonical (golden-locked) parameter
summary and is planned end to end; ``--list`` also reports per-family
counts of registered generated representatives.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from .. import dora
from ..strategies import list_strategies
from . import get_scenario, iter_scenarios, list_scenarios


def _print_listing(tag: str = None) -> None:
    rows = [s.summary_row() for s in iter_scenarios(tag)]
    headers = ("name", "mode", "model", "devs", "t_qoe", "description")
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    print("  ".join("-" * w for w in widths))
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    print(f"\n{len(rows)} scenarios registered")
    _print_generator_coverage()


def _print_generator_coverage() -> None:
    """One coverage line per generator family: how many registered
    catalog representatives each has (the families themselves are
    unbounded — any seed is a valid deployment)."""
    from ..fleet import iter_fleets
    from .generate import FAMILIES
    counts = {fam: sum(1 for s in iter_scenarios("generated")
                       if fam in s.tags)
              for fam in sorted(FAMILIES)}
    fleet_count = sum(1 for f in iter_fleets("generated"))
    parts = [f"{fam}:{n}" for fam, n in counts.items()]
    parts.append(f"mixed_train_serve:{fleet_count} (fleet)")
    print(f"generator families ({len(FAMILIES) + 1}, seeded — see "
          f"--generate): registered representatives " + " ".join(parts))


def _print_fleet_listing(tag: str = None) -> None:
    from ..fleet import iter_fleets
    rows = [f.summary_row() for f in iter_fleets(tag)]
    headers = ("name", "tenants", "devs", "description")
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    print("  ".join("-" * w for w in widths))
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    print(f"\n{len(rows)} fleet scenarios registered")


def _run_fleets(names: List[str], requests: bool,
                json_path: Optional[str]) -> int:
    from .. import dora
    failures = 0
    artifact: Dict[str, Dict[str, object]] = {}
    for name in names:
        entry: Dict[str, object] = {}
        artifact[name] = entry
        print(f"\n===== {name} " + "=" * max(0, 60 - len(name)))
        try:
            session = dora.serve_fleet(name)
        except Exception as e:  # noqa: BLE001 — keep sweeping on failure
            print(f"[ERROR] fleet planning failed: {type(e).__name__}: {e}")
            entry["error"] = f"{type(e).__name__}: {e}"
            failures += 1
            continue
        print(session.plan.summary())
        entry["plan"] = session.plan.to_dict()
        if not session.plan.feasible:
            failures += 1
        if requests:
            print("\nmulti-tenant serving simulation:")
            try:
                trace = dora.simulate(name, mode="fleet", session=session)
                print(trace.summary())
                entry["serving"] = trace.to_dict()
            except Exception as e:  # noqa: BLE001 — keep sweeping
                print(f"[ERROR] fleet sim failed: {type(e).__name__}: {e}")
                entry["serving_error"] = f"{type(e).__name__}: {e}"
                failures += 1
    if json_path is not None:
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump({"fleets": artifact}, f, indent=2, allow_nan=False)
            f.write("\n")
        print(f"\nwrote {json_path}")
    return failures


def _run_generated(family: str, seed: int, count: int, strategy: str,
                   json_path: Optional[str]) -> int:
    """Sample ``count`` scenarios per family starting at ``seed``,
    print each draw's canonical summary, and plan it."""
    from .generate import generate, list_families, sample_params
    fams = list_families() if family == "all" else [family]
    failures = 0
    artifact: Dict[str, Dict[str, object]] = {}
    for fam in fams:
        for s in range(seed, seed + count):
            try:
                params = sample_params(fam, s)
            except KeyError as e:
                print(f"error: {e.args[0]}", file=sys.stderr)
                return 1
            print(params.summary())
            entry: Dict[str, object] = {"summary": params.summary()}
            artifact[params.name] = entry
            try:
                report = dora.plan(generate(fam, s), strategy=strategy)
            except Exception as e:  # noqa: BLE001 — keep sweeping
                print(f"  [ERROR] planning failed: "
                      f"{type(e).__name__}: {e}")
                entry["error"] = f"{type(e).__name__}: {e}"
                failures += 1
                continue
            verdict = "QoE ok" if report.meets_qoe else "QoE MISS"
            print(f"  -> {len(report.best.stages)} stages, "
                  f"{report.latency * 1e3:.2f} ms, "
                  f"{report.energy:.2f} J, {verdict}")
            entry["plan"] = report.to_dict()
            if not report.meets_qoe:
                failures += 1
    if json_path is not None:
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump({"generated": artifact}, f, indent=2, allow_nan=False)
            f.write("\n")
        print(f"\nwrote {json_path}")
    return failures


def _run(names: List[str], strategy: str, compare: Optional[Sequence[str]],
         simulate: bool, requests: bool, json_path: Optional[str]) -> int:
    failures = 0
    artifact: Dict[str, Dict[str, object]] = {}
    for name in names:
        try:
            sc = get_scenario(name)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            failures += 1
            continue
        entry: Dict[str, object] = {}
        artifact[sc.name] = entry
        print(f"\n===== {name} " + "=" * max(0, 60 - len(name)))
        if compare is not None:
            strategies = list(compare) or list(dora.DEFAULT_COMPARISON)
            try:
                cmp = dora.compare(sc, strategies=strategies)
            except ValueError as e:      # e.g. a typo'd strategy name
                print(f"error: {e}", file=sys.stderr)
                entry["error"] = str(e)
                failures += 1
                continue
            print(cmp.summary())
            entry["compare"] = cmp.to_dict()
            failures += sum(1 for s in cmp.strategies if not cmp[s].ok)
            continue
        try:
            if strategy == "dora":
                session = dora.serve(sc)
                report = session.report
            else:
                session = None
                report = dora.plan(sc, strategy=strategy)
        except Exception as e:  # noqa: BLE001 — keep sweeping on failure
            print(f"[ERROR] planning failed: {type(e).__name__}: {e}")
            entry["error"] = f"{type(e).__name__}: {e}"
            failures += 1
            continue
        print(report.summary())
        entry["plan"] = report.to_dict()
        if requests:
            print("\nrequest-level serving simulation:")
            try:
                # copy=True: a later --simulate must see a fresh session,
                # and non-dora strategies reuse the plan already computed
                trace = dora.simulate(sc, mode="requests", copy=True,
                                      session=session, strategy=strategy,
                                      report=None if session else report)
                print(trace.summary())
                entry["serving"] = trace.to_dict()
            except Exception as e:  # noqa: BLE001 — keep sweeping
                print(f"[ERROR] serving sim failed: {type(e).__name__}: {e}")
                entry["serving_error"] = f"{type(e).__name__}: {e}"
                failures += 1
        if simulate and sc.timeline:
            if session is None:
                print("\n(--simulate needs the runtime adapter, which only "
                      "the 'dora' strategy arms; skipping timeline)")
            else:
                print("\ndynamics timeline:")
                trace = dora.simulate(sc, session=session)
                print(trace.summary())
                entry["simulate"] = trace.to_dict()
    if json_path is not None:
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump({"scenarios": artifact}, f, indent=2, allow_nan=False)
            f.write("\n")
        print(f"\nwrote {json_path}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="List or sweep Dora's registered deployment scenarios.")
    ap.add_argument("--list", action="store_true",
                    help="print the scenario registry and exit")
    ap.add_argument("--strategies", action="store_true",
                    help="print the planner-strategy registry and exit")
    ap.add_argument("--run", nargs="+", metavar="NAME",
                    help="plan the named scenario(s); 'all' sweeps the "
                         "whole registry")
    ap.add_argument("--tag", default=None,
                    help="filter --list/--run all by tag (e.g. paper, serve)")
    ap.add_argument("--strategy", default="dora", metavar="STRAT",
                    help="planner strategy for --run (see --strategies)")
    ap.add_argument("--compare", nargs="*", metavar="STRAT", default=None,
                    help="with --run: compare strategies side by side "
                         "(no names -> the default line-up)")
    ap.add_argument("--simulate", action="store_true",
                    help="with --run: also replay each scenario's dynamics "
                         "timeline through the runtime adapter")
    ap.add_argument("--requests", action="store_true",
                    help="with --run: request-level serving simulation at "
                         "the scenario's registered request rate (p50/p95/"
                         "p99 latency, SLO attainment, energy)")
    ap.add_argument("--json", default=None, metavar="PATH", dest="json_path",
                    help="with --run: write plans/comparisons/traces as one "
                         "machine-readable JSON artifact")
    ap.add_argument("--fleet", action="store_true",
                    help="operate on the multi-tenant fleet registry: "
                         "--list prints it, --run co-plans fleets "
                         "(dora.plan_fleet) and --requests runs the "
                         "multi-tenant serving simulator")
    ap.add_argument("--generate", default=None, metavar="FAMILY",
                    help="sample scenarios from a generator family "
                         "(repro_torch.scenarios.generate) and plan each; "
                         "'all' sweeps every family")
    ap.add_argument("--seed", type=int, default=0,
                    help="with --generate: first seed (default 0)")
    ap.add_argument("--count", type=int, default=1,
                    help="with --generate: seeds per family (default 1)")
    args = ap.parse_args(argv)

    if args.strategies:
        for name in list_strategies():
            print(name)
        print(f"\n{len(list_strategies())} strategies registered")
        return 0
    if args.generate:
        return _run_generated(args.generate, args.seed, args.count,
                              args.strategy, args.json_path)
    if args.fleet:
        from ..fleet import list_fleets
        if args.list or not args.run:
            _print_fleet_listing(args.tag)
            return 0
        names = (list_fleets(args.tag) if args.run == ["all"]
                 else list(args.run))
        return _run_fleets(names, args.requests, args.json_path)
    if args.list or not args.run:
        _print_listing(args.tag)
        return 0
    names = (list_scenarios(args.tag) if args.run == ["all"]
             else list(args.run))
    return _run(names, args.strategy, args.compare, args.simulate,
                args.requests, args.json_path)


if __name__ == "__main__":
    sys.exit(main())
