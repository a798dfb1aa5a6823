"""Serving under runtime dynamics on the PyTorch port — Dora's adapter on a
camera ring.

1. Dora plans inference for the Traffic Monitor fleet (ring + WiFi), with
   the port's copy of the planner (``repro_torch.dora``).
2. A background-interference timeline hits the fleet; the Runtime
   Adapter absorbs small fluctuations with network-only rescheduling
   and replans (async + delta switching) on large shifts.
3. A real reduced model serves batched requests through prefill/decode
   with its KV cache (greedy), reporting tokens/sec on this host.

The steps are those of ``examples/traffic_monitor_serving.py``, plus
``--device`` (the card unless asked otherwise); on the card every decode
step runs the decode-attention kernel once a layer.

    PYTHONPATH=src python examples/traffic_monitor_serving_torch.py
    PYTHONPATH=src python examples/traffic_monitor_serving_torch.py --device cpu
"""
import argparse
import os
import sys
import time
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch

from repro_torch import dora
from repro_torch.configs import reduced_config
from repro_torch.core.adapter import DynamicsEvent
from repro_torch.models import build_model

TIMELINE = [
    ("t=10s  camera uploads footage (wifi −50%)",
     DynamicsEvent(t=10.0, bandwidth_scale={"wifi": 0.5})),
    ("t=20s  cam0 runs a detector (compute −40%)",
     DynamicsEvent(t=20.0, compute_speed={0: 0.6})),
    ("t=30s  interference clears",
     DynamicsEvent(t=30.0, compute_speed={0: 1.0},
                   bandwidth_scale={"wifi": 1.0})),
]
B, PROMPT, GEN = 4, 16, 32


@torch.no_grad()
def greedy(model, params, toks: torch.Tensor, gen: int):
    """Prefill ``toks`` (B, prompt), one warm-up decode step, then ``gen``
    greedy decode steps. Returns the (B, 1 + gen) int32 tokens (the
    prefill's, then each step's) and the decode loop's seconds."""
    dev = model.device
    b, prompt = toks.shape
    cache = model.init_cache(b, prompt + gen)
    logits, cache = model.prefill(params, toks.to(dev), cache)
    cur = torch.argmax(logits, -1).to(torch.int32)
    out = [cur]
    # warm-up: writes the first step's own entry, which the loop rewrites alike
    model.decode(params, cur, cache, torch.full((b,), prompt, dtype=torch.int32, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    for i in range(gen):
        pos = torch.full((b,), prompt + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode(params, cur, cache, pos)
        cur = torch.argmax(logits, -1).to(torch.int32)
        out.append(cur)
    tokens = torch.cat(out, dim=1).cpu()
    return tokens, time.time() - t0


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ---- 1 + 2. plan inference, then replay the dynamics timeline ----------
    # ``simulate`` = plan (partition → schedule) + runtime adapter armed
    # over the Pareto set, reacting to each event.
    trace = dora.simulate("traffic_monitor", events=TIMELINE)
    print("serving plan:", trace.report.best.summary(), "\n")
    print(trace.summary())

    # ---- 3. real batched decode on this host -------------------------------
    print("\nreal batched serving (reduced model, greedy decode):")
    cfg = reduced_config("qwen3_32b")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                         generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    tokens, dt = greedy(model, params, toks, GEN)
    print(f"  {B} streams × {GEN} tokens in {dt:.2f}s "
          f"= {B * GEN / dt:.0f} tok/s on {model.device}")
    return {"trace": trace, "tokens": tokens, "decode_steps": GEN + 1,
            "n_layers": cfg.n_layers, "seconds": dt, "params": params, "prompt": toks}


if __name__ == "__main__":
    main()
