#!/usr/bin/env python3
"""Times of h2o-danube-1.8b trained tensor-parallel on four cards and
shrunk to two by the elastic controller (card only; four cards).

    python3 tools/elastic_ranks.py

First the one-card plain step on cuda:0 (``make_train_step``, full width
and depth, bf16, batch 2 x 8192, remat="full", wq/wk at the fan-in of
d_model; two warm-up steps, then the median of three). Then the same
model on a (1, 4) ("data", "model") mesh, one nccl rank a card
(``chip_smoke.mesh_train_rank`` without the per-step plain comparison):
4 steps, a sharded checkpoint, ranks 2 and 3 fall silent and exit, the
elastic controller regroups ranks 0 and 1 into (1, 2), restores and takes
3 more steps. It prints the median step time on each mesh (the first step
on a mesh, which DTensor's sharding propagation warms up, left out) beside
the one-card step, the speedups, the recovery time (from the verdict to
the first resumed step's end) and its parts, and each rank's peak memory,
with the card's name and power limit. It exits non-zero with fewer than
four cards.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))


def one_card_ms(torch, cs) -> dict:
    """The plain step on cuda:0: median ms of steps 2-4, peak GiB."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = get_config(cs.MESH_ARCH)
    model, train_step = make_train_step(cfg, peak_lr=3e-4, warmup=2, total=5, remat="full",
                                        device="cuda:0")
    params = cs.fan_in_qk(cfg, model.init(torch.Generator(device="cuda:0").manual_seed(0)))
    opt = adamw_init(params)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.MESH_SEQ,
                                    global_batch=cs.MESH_BATCH, seed=0), device="cuda:0")
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(5):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, batch, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    data.close()
    peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    return dict(ms=ms, median=statistics.median(ms[2:]), peak_gib=peak / 2**30)


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("elastic_ranks: needs 4 CUDA cards", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    _build.build(["flash_attention", "flash_attention_bwd"])
    one = one_card_ms(torch, cs)
    cs.log(card, f"one card: {cs.MESH_ARCH} (24 layers, bf16, {cs.MESH_BATCH} x {cs.MESH_SEQ}) "
                 f"step {one['median']:.1f} ms (median of steps 2-4; all {one['ms']}), peak "
                 f"{one['peak_gib']:.2f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "pids"))
        run = cs.MeshRun(cs.MESH_ARCH, None, "bfloat16", cs.MESH_BATCH, cs.MESH_SEQ, 4, 2, 3,
                         os.path.join(tmp, "ckpt"), os.path.join(tmp, "pids"), compare=False)
        out = cs.mesh_phase(torch, card, run, 4, [f"cuda:{i}" for i in range(4)],
                            "h2o tp 4 -> 2 timing", timeout=480)
    med = {m: statistics.median(v[1:]) for m, v in out["step_ms_by_mesh"].items()}
    rem = out["remesh"]
    cs.log(card, f"tensor-parallel steps (median, first step on each mesh left out): "
                 + ", ".join(f"{m} {v:.1f} ms ({one['median'] / v:.3f}x the one-card "
                             f"{one['median']:.1f} ms)" for m, v in med.items())
                 + f"; recovery {rem['total_s']:.2f} s (failed ranks gone {rem['wait_s']:.2f} s, "
                   f"regroup + restore {rem['regroup_restore_s']:.2f} s, first step "
                   f"{rem['first_step_s']:.2f} s); checkpoint {out['ckpt_bytes'] / 1e9:.2f} GB "
                   f"in {out['save_s']:.1f} s; peak GiB a rank "
                   f"{ {k: round(v / 2**30, 2) for k, v in out['peak_bytes'].items()} }; "
                   f"branches {out['branches']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
