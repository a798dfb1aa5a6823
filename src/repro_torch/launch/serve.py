"""Batched serving driver with Dora-planned placement and a QoE monitor:
plan the deployment with the port's copy of Dora's planner, prefill a
batch of synthetic prompts, then greedy-decode, reporting prefill time and
per-token decode latency against the QoE target. With ``--dynamics`` it
feeds a mid-run slowdown to the runtime adapter and prints its decision
(paper Fig. 16 behavior at example scale).

    python -m repro_torch.launch.serve --arch qwen3_32b [--reduced] [--device cuda]
        [--setting smart_home_2] [--dynamics]

``--setting`` takes any registered scenario (``python -m
repro_torch.scenarios --list``). The model runs on one device; the plan is
printed, and the pipeline executor that runs a plan's stages is
``repro_torch.runtime.pipeline``.
An infeasible plan raises, as in the JAX package (qwen3_32b at the 200 ms
default does: ``--t-qoe-ms`` loosens the target).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import dora
from ..configs import get_config, reduced_config
from ..core import DynamicsEvent, QoESpec, Workload
from ..models.registry import planning_graph
from .steps import make_prefill_step, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--t-qoe-ms", type=float, default=200.0)
    ap.add_argument("--dynamics", action="store_true")
    ap.add_argument("--setting", default="smart_home_2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)

    # --- Dora plans the edge deployment for this model --------------------
    # the setting's fleet + this invocation's model/batch/QoE via overrides
    session = dora.serve(
        args.setting, graph=planning_graph(cfg, args.prompt_len),
        qoe=QoESpec(t_qoe=args.t_qoe_ms / 1e3, lam=100.0),
        workload=Workload(global_batch=args.batch, microbatch_size=1, training=False))
    result = session.report.result
    adapter = session.adapter
    print("Dora plan:", result.best.summary())
    print(f"planning took {result.total_s*1e3:.0f}ms "
          f"(phase1 {result.phase1_s*1e3:.0f}ms, phase2 {result.phase2_s*1e3:.0f}ms)")

    model, prefill_step = make_prefill_step(cfg, device=args.device)
    _, serve_step = make_serve_step(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cache = model.init_cache(args.batch, args.prompt_len + args.gen_len)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
                             dtype=torch.int32, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name}: {cfg.n_layers} layers on {name}")

    _sync(dev)
    t0 = time.perf_counter()
    tok, cache = prefill_step(params, tokens, cache)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"prefill({args.prompt_len} tokens): {prefill_ms:.1f}ms")
    lat = []
    dynamics = None
    for i in range(args.gen_len):
        pos = torch.full((args.batch,), args.prompt_len + i, dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        tok, cache = serve_step(params, tok, cache, pos)
        _sync(dev)
        lat.append((time.perf_counter() - t1) * 1e3)
        if args.dynamics and i == args.gen_len // 2:
            ev = DynamicsEvent(t=time.perf_counter() - t0, compute_speed={0: 0.6},
                               bandwidth_scale={"wifi": 0.7})
            plan, action, dt = adapter.on_dynamics(result.best, ev)
            print(f"  [dynamics] adapter action={action} in {dt*1e3:.0f}ms; "
                  f"plan latency {result.best.latency*1e3:.0f} -> "
                  f"{plan.latency*1e3:.0f}ms")
            dynamics = {"action": action, "plan": plan, "react_s": dt}
    lat = np.array(lat[1:] if len(lat) > 1 else lat)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"decode: p50={p50:.1f}ms p99={p99:.1f}ms QoE target={args.t_qoe_ms:.0f}ms "
          f"({'MET' if p99 < args.t_qoe_ms else 'MISSED'} locally)")
    return {"prefill_ms": prefill_ms, "p50_ms": p50, "p99_ms": p99,
            "last_token": tok.cpu().numpy(), "plan": result.best,
            "plan_summary": result.best.summary(), "planning_s": result.total_s,
            "dynamics": dynamics}


if __name__ == "__main__":
    main()
