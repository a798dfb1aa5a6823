"""``python -m repro_torch.calibrate`` -- measure, calibrate, check fidelity.

Default run: microbenchmark the card, build the ProfiledCosts artifact,
run the fidelity suite (plan -> price both ways -> execute -> compare) and
rewrite ``calibration/h100_fidelity.json`` (on the CPU, the git-ignored
``build/calibration/cpu_fidelity.json``: a CPU run never writes the card's
record). ``--check`` is the regression
gate: re-run the quick subset with the cache off and fail on calibrated-
error regression. ``--device cuda`` (the default) raises where no card is
present; it never falls back to the CPU, which only ``--device cpu``
measures.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="device calibration + plan-vs-execution fidelity bench")
    ap.add_argument("--device", default="cuda",
                    help="the device to measure: cuda (default; raises without a "
                         "card) or cpu")
    ap.add_argument("--devices", type=int, default=4,
                    help="logical fleet size: the pipeline stages that share the "
                         "device (default 4)")
    ap.add_argument("--quick", action="store_true",
                    help="small fidelity cases only (also via BENCH_QUICK=1)")
    ap.add_argument("--check", action="store_true",
                    help="regression gate on the quick subset "
                         "(implies --quick, ignores the measurement cache)")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="also write the ProfiledCosts JSON here "
                         "(e.g. calibration/h100.json)")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="measurement cache file ('none' disables; default "
                         "~/.cache/repro_torch-calibrate/measurements.json)")
    args = ap.parse_args(argv)
    quick = args.quick or bool(os.environ.get("BENCH_QUICK"))

    from .timing import Fleet, MeasurementCache
    fleet = Fleet(args.device, args.devices)

    if args.cache == "none" or (args.check and not args.cache):
        cache = MeasurementCache(path=None, fleet=fleet)
    elif args.cache:
        cache = MeasurementCache(path=args.cache, fleet=fleet)
    else:
        cache = MeasurementCache(fleet=fleet)

    from . import fidelity
    bench = fidelity.BENCH_PATH if fleet.torch_device().type == "cuda" \
        else fidelity.CPU_BENCH_PATH
    if args.check:
        return fidelity.check_regression(bench, fleet)

    from .host import calibrate_host
    costs = calibrate_host(cache, quick=quick, path=args.artifact)
    print(f"calibrated {costs.name}: "
          f"compute_factor={next(iter(costs.compute_factor.values())):.4f} "
          f"({len(costs.compute_factor)} devices)")
    if args.artifact:
        print(f"wrote {args.artifact}")

    current = fidelity.run_fidelity(quick=quick, cache=cache)
    os.makedirs(os.path.dirname(os.path.abspath(bench)), exist_ok=True)
    if quick:
        fidelity.write_quick(current, bench)
    else:
        fidelity.write_bench(current, bench)
    for name, rec in current["cases"].items():
        print(f"  {name} ({rec['mode']}, S={rec['n_stages']}): "
              f"measured={rec['measured_s']*1e3:.1f}ms  "
              f"calibrated={rec['calibrated']['predicted_s']*1e3:.1f}ms "
              f"(err {rec['calibrated']['rel_err']:.1%})  "
              f"uncalibrated={rec['uncalibrated']['predicted_s']*1e3:.1f}ms "
              f"(err {rec['uncalibrated']['rel_err']:.1%})")
    print(f"mean rel err: calibrated "
          f"{current['mean_rel_err_calibrated']:.3f} vs uncalibrated "
          f"{current['mean_rel_err_uncalibrated']:.3f} "
          f"(gain {current['calibration_gain']:.1f}x)")
    print(f"wrote {bench}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
