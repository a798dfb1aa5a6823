#!/usr/bin/env python3
"""The quick fidelity cases' layouts with one rank a card (card only).

    python3 tools/pipeline_ranks.py

For each of ``repro_torch.calibrate.fidelity.QUICK_CASES`` (2 stages) it
first runs ``fidelity.run_case`` on a logical fleet of 2 on cuda:0, as the
one-card fidelity suite does: the measured iteration through the in-process
executor and the calibrated prediction. Then it executes the same layout
through ``DistributedPipelineExecutor``, one nccl rank a card
(cuda:0, cuda:1, ...), timed as ``fidelity.execute_layout`` times it (best of
``CASE_REPEATS`` wall seconds after one warm-up, float32 with TF32 off; here
between barriers). It prints predicted over measured for both executions
beside the GPipe bubble factor (M + S - 1) / M that the planner prices. It
needs as many cards as the cases have stages and exits non-zero without
them. The measurement cache lives in a temporary directory.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def rank_case(rank: int, world: int, case, layout, wl, repeats: int) -> float:
    """This rank's stage of ``layout``: best-of-``repeats`` seconds of one
    iteration (forward; training adds the loss's backward)."""
    import torch
    import torch.distributed as dist

    from repro_torch.calibrate.microbench import gated_mlp_layer, init_gated_mlp
    from repro_torch.calibrate.timing import full_f32
    from repro_torch.core import ParallelismPlan, Stage
    from repro_torch.runtime.pipeline import DistributedPipelineExecutor, stage_block

    device = torch.device("cuda", torch.cuda.current_device())
    plan = ParallelismPlan(stages=[Stage(node_ids=list(ids), devices=[dev],
                                         microbatch_split={dev: 1.0}) for ids, dev in layout],
                           microbatch_size=wl.microbatch_size, n_microbatches=wl.n_microbatches,
                           training=wl.training)
    ex = DistributedPipelineExecutor(plan, case.n_layers, gated_mlp_layer)
    block = stage_block(init_gated_mlp(case.n_layers, case.d_model, case.d_ff,
                                       torch.Generator(device=device).manual_seed(0)),
                        ex.spec, rank)
    x = torch.randn((wl.n_microbatches, case.rows(wl), case.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))

    def run():
        if wl.training:
            return ex.loss_and_grads(block, x, lambda out: torch.mean(out * out))
        return ex.forward(block, x)
    best = float("inf")
    with full_f32():
        for i in range(1 + repeats):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            dist.barrier()
            if i:
                best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import torch

    from repro_torch.calibrate import fidelity
    from repro_torch.calibrate.host import host_topology
    from repro_torch.calibrate.microbench import (matmul_peak_flops, memory_bandwidth,
                                                  transfer_goodput)
    from repro_torch.calibrate.timing import Fleet, MeasurementCache
    from repro_torch.runtime.ranks import run_ranks
    from repro_torch.scenarios import get_scenario

    if not torch.cuda.is_available():
        print("pipeline_ranks: no CUDA device", file=sys.stderr)
        return 2
    need = max(c.n_devices for c in fidelity.QUICK_CASES)
    if torch.cuda.device_count() < need:
        print(f"pipeline_ranks: needs {need} cards, saw {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cache = MeasurementCache(os.path.join(tmp, "cache.json"), Fleet("cuda", need))
        fleet = cache.fleet
        for case in fidelity.QUICK_CASES:
            rec = fidelity.run_case(case, cache, quick=True)
            # the layout run_case executed: its measurements are cached now
            wl = get_scenario(case.scenario).workload
            graph = fidelity.proxy_graph(case)
            measure = {
                "matmul_peak_flops": cache.get_or_measure(
                    "matmul_peak", "d512", lambda: matmul_peak_flops(512, device=fleet.device)),
                "memory_bw": cache.get_or_measure(
                    "memory_bw", "64MiB", lambda: memory_bandwidth(device=fleet.device)),
                "transfer_large_bps": cache.get_or_measure(
                    "transfer", "16MiB", lambda: transfer_goodput(1 << 24, fleet=fleet)),
                "transfer_small_bps": cache.get_or_measure(
                    "transfer", "64KiB", lambda: transfer_goodput(1 << 16, fleet=fleet)),
            }
            topo = host_topology(measure, case.n_devices,
                                 memory=fidelity.fleet_memory(graph, wl, case.n_devices))
            layout, source = fidelity.plan_layout(graph, topo, wl)
            S, M = len(layout), wl.n_microbatches
            if S != rec["n_stages"]:
                raise AssertionError(f"{case.scenario}: layout of {S} stages, run_case ran "
                                     f"{rec['n_stages']}")
            ranks_s = max(run_ranks(rank_case, S, (case, layout, wl, fidelity.CASE_REPEATS),
                                    backend="nccl", timeout=600,
                                    devices=[f"cuda:{i}" for i in range(S)]))
            pred = rec["calibrated"]["predicted_s"]
            print(f"[{card}] {case.scenario} ({rec['mode']}, {source} layout, {S} stages, "
                  f"{M} microbatches, bubble factor (M + S - 1) / M = {(M + S - 1) / M:.3f}): "
                  f"calibrated prediction {pred * 1e3:.3f} ms; one card, in-process executor "
                  f"{rec['measured_s'] * 1e3:.3f} ms (predicted / measured "
                  f"{pred / rec['measured_s']:.3f}); one nccl rank a card "
                  f"{ranks_s * 1e3:.3f} ms (predicted / measured {pred / ranks_s:.3f}); "
                  f"uncalibrated prediction {rec['uncalibrated']['predicted_s'] * 1e3:.3f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
