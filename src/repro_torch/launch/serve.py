"""Batched serving driver: prefill a batch of synthetic prompts, then
greedy-decode, reporting prefill time and per-token decode latency against
the QoE target.

    python -m repro_torch.launch.serve --arch qwen3_32b [--reduced] [--device cuda]

The JAX driver also plans the deployment with Dora (``--setting``) and
injects dynamics (``--dynamics``); both need the planner, which the port
does not reach yet (ROADMAP), so this driver runs the model alone.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, reduced_config
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
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
    for i in range(args.gen_len):
        pos = torch.full((args.batch,), args.prompt_len + i, dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        tok, cache = serve_step(params, tok, cache, pos)
        _sync(dev)
        lat.append((time.perf_counter() - t1) * 1e3)
    lat = np.array(lat[1:] if len(lat) > 1 else lat)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"decode: p50={p50:.1f}ms p99={p99:.1f}ms QoE target={args.t_qoe_ms:.0f}ms "
          f"({'MET' if p99 < args.t_qoe_ms else 'MISSED'} locally)")
    return {"prefill_ms": prefill_ms, "p50_ms": p50, "p99_ms": p99,
            "last_token": tok.cpu().numpy()}


if __name__ == "__main__":
    main()
