#!/usr/bin/env python3
"""The run-to-run spread of the fidelity suite's calibrated error, at the
port's best-of-N for a case's two timings (``fidelity.CASE_REPEATS``) and
at best of 3, within the JAX package's 2-4.

    python3 tools/fidelity_spread.py [RUNS] [--device cuda|cpu]

Each reading is a fresh process that does what ``chip_smoke.py``'s phase
7 does before its regression gate: ``calibrate_host`` on a logical fleet
of 4 with an in-memory cache, then the full and the quick cases. RUNS readings of each setting (default 8) run in turns, 10 first.
Prints one JSON line a reading (both means, each case's error, measured
and predicted ms), then for each setting the least, greatest and standard
deviation of the quick and full calibrated means, and how many quick means
the regression gate (``check_regression``) would fail against the committed
``calibration/h100_fidelity.json``. Needs a CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
from repro_torch.calibrate import fidelity  # noqa: E402

SETTINGS = (fidelity.CASE_REPEATS, 3)


def reading(repeats: int, device: str) -> dict:
    """One reading in this process, the cases timed best of ``repeats``."""
    import torch
    from repro_torch.calibrate import host, timing

    torch.backends.cuda.matmul.allow_tf32 = False
    fidelity.CASE_REPEATS = repeats
    cache = timing.MeasurementCache(path=None, fleet=timing.Fleet(device, 4))
    host.calibrate_host(cache)
    out = {"case_repeats": repeats}
    for label, cases in (("full", fidelity.CASES), ("quick", fidelity.QUICK_CASES)):
        rec = fidelity.run_fidelity(cases, quick=label == "quick", cache=cache)
        out[label] = rec["mean_rel_err_calibrated"]
        out[f"{label}_uncalibrated"] = rec["mean_rel_err_uncalibrated"]
        out[f"{label}_cases"] = {
            name: dict(rel_err=r["calibrated"]["rel_err"], measured_ms=r["measured_s"] * 1e3,
                       calibrated_ms=r["calibrated"]["predicted_s"] * 1e3)
            for name, r in rec["cases"].items()}
    return out


def gate_threshold() -> float:
    """max(1.5 x the committed quick calibrated mean, GATE_FLOOR)."""
    with open(os.path.join(REPO, "calibration", "h100_fidelity.json"), encoding="utf-8") as f:
        committed = json.load(f)["quick"]["mean_rel_err_calibrated"]
    return max(1.5 * committed, 0.25)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one", type=int, choices=SETTINGS,
                    help="take one reading in this process, best of ONE")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(reading(args.one, args.device)), flush=True)
        return 0
    readings = {s: [] for s in SETTINGS}
    for _ in range(args.runs):
        for s in SETTINGS:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", str(s),
                                  "--device", args.device],
                                 capture_output=True, text=True, check=True).stdout
            line = out.strip().splitlines()[-1]
            print(line, flush=True)
            readings[s].append(json.loads(line))
    limit = gate_threshold()
    for s, rs in readings.items():
        for label in ("quick", "full"):
            v = [r[label] for r in rs]
            sd = statistics.stdev(v) if len(v) > 1 else 0.0
            print(f"best of {s}: {label} calibrated mean "
                  f"{min(v):.4f}-{max(v):.4f}, sd {sd:.4f} over {len(v)}: "
                  + ", ".join(f"{x:.4f}" for x in v))
        over = sum(r["quick"] > limit for r in rs)
        print(f"best of {s}: {over} of {len(rs)} quick means above the gate's {limit:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
