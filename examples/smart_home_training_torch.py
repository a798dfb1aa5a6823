"""End-to-end training on the PyTorch port: plan with Dora, then train.

1. Dora plans hybrid parallelism for the Smart Home 2 fleet (QoE-aware),
   with the port's copy of the planner (``repro_torch.dora``).
2. The port trains a small qwen-family model on the synthetic token stream
   with AdamW, async checkpointing and restart.

The steps and arguments are those of ``examples/smart_home_training.py``,
plus ``--device`` (the card unless asked otherwise). The model defaults to
a ~10M-parameter reduced config; ``--big`` takes a ~100M-parameter one.
A second run with the same ``--ckpt-dir`` resumes from its last committed
step.

    PYTHONPATH=src python examples/smart_home_training_torch.py --steps 200
    PYTHONPATH=src python examples/smart_home_training_torch.py --device cpu --steps 40
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch import dora
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import reduced_config
from repro_torch.core.cost_model import Workload
from repro_torch.core.graph_builders import GraphSpec, build_lm_graph
from repro_torch.core.qoe import QoESpec
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves


def model_cfg(big: bool):
    base = reduced_config("qwen3_32b")
    if big:   # ~100M params
        return dataclasses.replace(base, n_layers=12, d_model=768,
                                   n_heads=12, n_kv_heads=4, head_dim=64,
                                   d_ff=2048, vocab_size=32768)
    return dataclasses.replace(base, n_layers=8, d_model=256, n_heads=8,
                               n_kv_heads=4, head_dim=32, d_ff=1024,
                               vocab_size=8192)


def plan(cfg, seq: int):
    """The fleet's plan: the smart_home_2 scenario with the trained model's
    graph, this run's QoE target and the example's workload."""
    spec = GraphSpec("home-lm", cfg.n_layers, cfg.d_model, cfg.n_heads,
                     cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
                     head_dim=cfg.head_dim, seq_len=seq)
    return dora.plan("smart_home_2", graph=build_lm_graph(spec),
                     qoe=QoESpec(t_qoe=2.0, lam=10.0),
                     workload=Workload(global_batch=32, microbatch_size=4,
                                       optimizer_mult=3.0))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "dora_smart_home_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ---- 1. QoE-aware plan for the edge fleet -----------------------------
    # the scenario supplies fleet + workload; we swap in the actual
    # (reduced) model being trained and this run's QoE target.
    cfg = model_cfg(args.big)
    report = plan(cfg, args.seq)
    print("Dora plan for the fleet:", report.best.summary())
    print(f"(planned in {report.result.total_s:.2f}s; executing the training loop "
          f"locally on {args.device})\n")

    # ---- 2. real training on the port -------------------------------------
    model, train_step = make_train_step(cfg, peak_lr=1e-3,
                                        warmup=max(args.steps // 20, 5),
                                        total=args.steps, remat="none",
                                        device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params")
    opt = adamw_init(params)
    ckpt = Checkpointer(args.ckpt_dir)
    step0 = latest_step(args.ckpt_dir) or 0
    if step0:
        tree = ckpt.restore(step0, {"params": params, "opt": opt})
        params, opt = tree["params"], tree["opt"]
        print(f"resumed from checkpoint step {step0}")

    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    global_batch=args.global_batch), device=dev)
    losses, t0 = [], time.time()
    for step in range(step0, args.steps):
        params, opt, m = train_step(params, opt, next(data), step)
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  ({time.time() - t0:.0f}s)", flush=True)
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt})
    ckpt.save(args.steps, {"params": params, "opt": opt}, wait=True)
    data.close()
    out = {"plan": report, "n_params": n_params, "step0": step0, "losses": losses,
           "opt_count": int(opt["count"])}
    if losses:
        out.update(first=float(np.mean(losses[:10])), final=float(np.mean(losses[-10:])))
        print(f"\nloss {out['first']:.3f} → {out['final']:.3f}"
              f"  (checkpoints in {args.ckpt_dir})")
    else:
        print(f"\nnothing to train: the checkpoint is at step {step0} of {args.steps}")
    return out


if __name__ == "__main__":
    main()
