"""End-to-end training driver (PyTorch counterpart of ``repro.launch.train``):
model, AdamW, token pipeline, a device mesh over the process group, and
sharded async checkpointing with restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_32b \
        --reduced --steps 200 --global-batch 8 --seq 128 [--device cuda]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3_32b --reduced --device cpu --steps 4

The flags are the JAX driver's plus ``--device`` (the card unless asked
otherwise). With a process group (``torchrun``, which this driver joins
over nccl on the card it is given and gloo on the CPU, or ranks started by
``runtime.ranks.run_ranks``), it trains under the JAX driver's mesh: every
rank of the group as a (1, world) ('data', 'model') mesh, the parameters and
AdamW state laid out by ``ShardingRules``; without one, on one device. Every
arch trains either way. whisper_small's batches carry zero encoder frames
and paligemma_3b's zero patch embeddings (the frontend stubs, as in the JAX
launcher, in the model's dtype, laid out on the mesh as the batch). With
``--ckpt-dir`` it restores the latest committed step onto the mesh it runs
on and saves (sharded) every ``--ckpt-every`` steps and at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer, latest_step
from ..configs import get_config, reduced_config
from ..data import DataConfig, TokenPipeline
from ..models.sharding import ShardingRules
from ..models.sharding_utils import distribute_tree
from ..optim import adamw_init
from .mesh import make_host_mesh, use_mesh
from .steps import frontend_stubs, make_train_step


def _join_torchrun(device: str) -> bool:
    """Join the group ``torchrun`` describes in the environment (nccl on the
    card of ``LOCAL_RANK``, gloo on the CPU); False when there is none or a
    group is already up."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo")
    return True


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    joined = _join_torchrun(args.device)
    try:
        return _train(args, cfg)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, cfg) -> dict:
    model, train_step = make_train_step(cfg, peak_lr=args.lr,
                                        warmup=max(args.steps // 20, 5),
                                        total=args.steps, remat="none", device=args.device)
    dev = model.device
    mesh = make_host_mesh(dev) if dist.is_initialized() else None
    stubs = frontend_stubs(cfg, args.global_batch, dev, mesh=mesh)
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    if mesh is not None:
        params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
        say(f"training on a {tuple(mesh.shape)} ('data', 'model') mesh of "
            f"{dist.get_world_size()} ranks ({dist.get_backend()})")
    opt = adamw_init(params)
    step0 = 0
    ckpt = None
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        if args.ckpt_dir:
            ckpt = Checkpointer(args.ckpt_dir)
            last = latest_step(args.ckpt_dir)
            if last is not None:
                tree = ckpt.restore(last, {"params": params, "opt": opt})
                params, opt = tree["params"], tree["opt"]
                step0 = last
                say(f"restored checkpoint step {last}")

        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                        global_batch=args.global_batch, seed=args.seed),
                             device=dev, mesh=mesh)
        losses = []
        t0 = time.time()
        for step in range(step0, args.steps):
            batch = {**next(data), **stubs}
            params, opt, metrics = train_step(params, opt, batch, step)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} ({time.time() - t0:.1f}s)", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt})
        if ckpt:
            ckpt.save(args.steps, {"params": params, "opt": opt}, wait=True)
        data.close()
    out = {"losses": losses, "step0": step0, "params": params, "opt": opt}
    if not losses:
        say(f"nothing to train: the checkpoint is at step {step0} of {args.steps}")
        return out
    first, final = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    say(f"loss {first:.4f} -> {final:.4f} "
        f"({'improved' if final < first else 'NOT improved'})")
    return {**out, "first": first, "final": final}


if __name__ == "__main__":
    main()
