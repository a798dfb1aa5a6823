#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/ (one nvcc a source, all
started together; each instance's registers, stack, spills and shared
memory printed from ``ptxas -v``, the HMMA count of each SSD stage, forward
and bf16 backward, and the HGMMA count of the flash backward's main kernel
from ``cuobjdump -sass``; a spill in the flash backward fails) and runs these
phases:

1. the device: name and power limit from nvidia-smi;
2. each kernel against its plain PyTorch version at the serving paths'
   shapes (bf16 qwen3-32b attention, recurrentgemma-9b's head_dim-256
   prefill above its window and decode, h2o-danube-1.8b's head_dim-80
   prefill (also at 8192 tokens, where its 4096 window binds) and decode,
   granite-20b's 48 query heads on one KV head, olmoe-1b-7b's 16 query
   heads on 16 KV heads (G = 1, prefill and decode, also in float32 for
   phase 3's check; the forward also at its training shape, B = 2),
   decode at whisper-small's head_dim 64 with G = 1 and
   paligemma-3b's head_dim 256 with G = 8 (their served caches, also ragged
   and in float32), mamba2-780m's SSD scan
   with each of its four bf16 stages timed by the profiler,
   recurrentgemma-9b's RG-LRU scan at its prefill and training shapes,
   and with a carried state, decay near one or none, at the training shape,
   off a whole round, short, W off the tile and B = 1, kernel and plain
   version held to a float64 run, two launches checked bit for bit) plus
   ragged, windowed, grouped,
   empty-split and float32 cases, each error printed beside its bound
   (see ``check``), with times of the kernel, the plain version and,
   where one PyTorch call computes the same function, that call as a
   yardstick, timed in turns with the kernel (``paired_ms``; decode with
   L2 flushed before each launch); the flash backward (dq, dk, dv) at
   qwen3-32b's training shape (B=2, S=4096), h2o-danube-1.8b's (B=2,
   S=8192, head_dim 80, window 4096) and granite-20b's group (G = 48),
   olmoe-1b-7b's (B=2, S=4096, 16 heads on 16 KV heads of 128: G = 1),
   and at head_dim 64, G = 1, a 2048 window, ragged S, the query group
   split across blocks (G = 48, one key tile) and float32, each of its
   three kernels (dsum, the wgmma kernel, the convert) timed by the
   profiler, with its split plan and block count, against
   scaled_dot_product_attention's backward; the bf16 flash backward at
   head_dim 256 (its own 64-key instance) at recurrentgemma-9b's training
   shape (B=2, S=4096, 16 heads on one KV head, window 2048), ragged, a
   window of 40 and a group split over every head; the RG-LRU scan's
   backward at the training shape (B=2, S=4096, W=4096) and off its step
   group and channel block, with and without h_last's cotangent and without
   h's, against its plain version (float32); the flash forward and
   backward at phase 6's microbatch shapes (granite-8b's 1 x 4096, 32 heads
   on 8 of 128; h2o-danube-1.8b's 2 x 4096 in bf16 and float32); decode at
   head_dim 16 (calibration's reduced qwen3 decode step in float32, longer
   caches in both types); and the SSD scan's backward (dx, da_log, db, dc)
   at mamba2-780m's training shape (B=4, S=4096, bf16; each of its six
   bf16 kernels timed by the profiler) and the reduced calibration step's
   (float32), grouped, ragged chunk, with and without the final state's
   cotangent, against its plain version; and every kernel at the shapes of
   phase 7's calibration path in float32 (``kernel_rates``' flash, decode,
   SSD scan and RG-LRU shapes, and the reduced mamba2 train step's SSD
   scan forward); and decode's sharded-keys mode (``decode_attention_partial``)
   at qwen3-32b's decode shape in 4 shards and at h2o-danube-1.8b's d = 80
   with its window, each shard's o and lse against the plain version, the
   shards merged against the one-card kernel, a quarter shard timed beside
   the whole cache;
3. four serving paths, each at full width, bf16, batch 4, with launch
   counters (zeroed just before the path runs, read just after) showing
   its kernels ran on every layer, a profiler window (device time by
   kernel, busy share) over one prefill and three decode steps, and a
   check at batch 1 that decode steps agree with a fresh prefill:
   qwen3-32b (depth cut to 8 layers; prefill 4096, 32 decode steps),
   mamba2-780m (all 48 layers; prefill 4096, 32 steps) and
   recurrentgemma-9b (all 38 layers; prefill 2048, 32 steps, the
   2048-slot local-attention ring wrapping from the first step),
   h2o-danube-1.8b (all 24 layers, head_dim 80; prefill 4096, 32 steps,
   the 4096-slot window ring wrapping from the first step), olmoe-1b-7b
   (all 16 MoE layers, 64 experts top-8 at the reference's capacity factor
   1.25; prefill 4096, 32 steps) and deepseek-v2-236b (depth cut to 4
   layers: the dense-first layer and 3 MoE layers of 160 experts top-6 plus
   2 shared, MLA attention with no kernel; prefill 4096 through MLA's
   query-chunked path, 32 steps), whisper-small (all 12 encoder and 12
   decoder layers over 1500 stub frames; prefill 224, no launch, 32 steps of
   12 decode launches) and paligemma-3b (all 18 layers, 256 stub patches
   before the prompt, attending bidirectionally; prefill 128, no launch, 32
   steps of 18 decode launches); each path also prints its decode step's
   weight bytes and the floor they set at 3.35 TB/s beside its p50, and an
   MoE path its prefill's routing (groups, capacity, the share of routed
   slots its MoE layers dropped); the MoE paths' checks run at the lossless
   capacity factor n_experts / experts_per_token;
4. small float32 models of six families on the card against the same
   models on the CPU, the recurrentgemma and h2o (head_dim 80) ones
   decoding past their windows so the rings wrap on both devices, the
   reduced olmoe (head_dim 64, the flash and decode kernels at G = 1) and the
   reduced deepseek (MLA's query-chunked prefill) also on every cache leaf;
   and a
   float32 train step of a small qwen3-family model (head_dim 64) and of a
   small h2o-family model (head_dim 80, a window below S), each with
   attn_chunk 64 < S = 256 so the flash forward and backward kernels run,
   of the reduced recurrentgemma (head_dim 64, S = 256 above its window of
   32: the RG-LRU scan's and the flash kernels, forward and backward), and
   of the reduced mamba2 (S = 128, chunk 32: the SSD scan's forward
   and backward kernels), of the reduced olmoe (head_dim 64, attn_chunk 64
   < S = 256: the flash kernels at G = 1, slots dropped at capacity 1.25)
   and of the reduced deepseek (MLA's query chunks under the units' remat,
   no kernel), on the card against the CPU: loss, the MoE aux loss, grad
   norm and every gradient;
5. training through ``make_train_step`` and ``TokenPipeline`` (bf16,
   remat="full", 10 steps each): qwen3-32b at full width (depth cut to 4
   layers, batch 2 x 4096), then h2o-danube-1.8b at full width and depth
   (24 layers, batch 2 x 8192, above its 4096 window), then mamba2-780m at
   full width and depth (48 layers, batch 4 x 4096), then
   recurrentgemma-9b at full width (depth cut to 8 layers: two (rec, rec,
   local_attn) units and the two-layer rec tail; batch 2 x 4096 above its
   2048 window; wq and wk at the fan-in of d_model), then whisper-small at
   full width and depth (batch 8 x 448 over 1500 frames) and paligemma-3b at
   full width (depth cut to 4 layers; batch 2 x 512 after 256 patches), both
   launching no kernel, then olmoe-1b-7b at full width (depth cut to 8 of 16
   MoE layers; batch 2 x 4096, the reference's capacity factor 1.25; the
   dropped share of an untimed forward before and after the steps and the
   expert products' capacity overhead printed):
   each step's loss
   (the last below the first), its launches checked exactly (a stacked
   layer's kernel two forwards, forward and recompute, and one backward;
   a tail layer's, which is not rematerialised, one of each), the median
   step time, tokens/s, the model-FLOP share of 989 TFLOP/s, peak memory,
   a profiler window over one step with the flash forward's and
   backward's shares; after qwen3's steps a Checkpointer round trip of the
   trained parameters and AdamW state, restored onto the card bit for
   bit; after olmoe's steps ``ef_compress`` over the gradients of the
   trained parameters, a second call carrying the first's residual against
   the same call on CPU copies (bit for bit, the residual norm within 1e-5);
   deepseek-v2-236b's loss and gradients at full width (3 of 60 layers: the
   dense-first tail and two MoE units; batch 1 x 4096, MLA's query chunks
   nested in the units' remat; no optimizer), 3 passes, every gradient
   finite, no launch; and the train launcher (``python -m repro_torch.launch.train --arch
   recurrentgemma_9b --reduced --steps 20``, through its ``main``): the loss
   falls and every rec layer launches the RG-LRU scan forward and backward
   once a step;
6. a Dora plan on the card: the port's planner plans granite-8b on
   smart_home_2 (serve) and h2o-danube-1.8b on traffic_monitor (train),
   each plan's summary, stage layout and planning time (host CPU)
   printed, two stages at least; the pipeline executor runs granite-8b
   at full width and depth forward on its 3 stages (4 microbatches of 1 x
   4096, bf16) against the same layers microbatch by microbatch in plain
   order, and h2o-danube-1.8b's loss and gradients on its 4 stages (4
   microbatches of 2 x 4096, each stage remat'd) against
   ``LM.loss(remat="full")``, in bf16 (launches, padded slots' zero
   gradients, the loss, times; against float32 ``LM.loss`` the gradients
   may use at most 1.5 times the share of the backward's bound that bf16
   ``LM.loss``'s use) and in float32 (every gradient within 1e-4 of its
   leaf's max); then both plans again through the executor across
   processes (``DistributedPipelineExecutor``, one gloo rank a stage, all
   on cuda:0, started by ``runtime.ranks.run_ranks``) against the
   in-process executor's runs: granite-8b's forward bitwise (else within
   the bf16 bound), h2o-danube-1.8b's gradients in bf16 (the same gate
   against float32 ``LM.loss``) and float32 (1e-4 of each leaf's max), the
   launches summed over the ranks equal to the in-process counts, each
   rank's stage time, bytes sent and peak memory, and the wall time beside
   the in-process executor's (not gated: the ranks share the card); a small float32 h2o-family
   model through the same plan, card against CPU; and the serve launcher
   (``launch/serve.py``, h2o-danube-1.8b at full depth, edge_cluster,
   ``--dynamics``) with its launches checked exactly; then a catalogue
   scenario beyond Table 3 (``CATALOGUE``, vehicle_platoon): the serve
   launcher on it (launches exact), granite-8b planned on it through
   ``dora.serve``, each event of its timeline fed to the control plane
   (``on_dynamics``, a replan each) and the plan it holds then run through
   the executor as above (bitwise against the plain order, launches exact),
   and the planning stack's host code without jax: ``python -m
   repro_torch.scenarios --run vehicle_platoon --simulate --requests`` in a
   process of its own (a finite p99) and ``dora.compare`` (dora meets the
   QoE, as in the JAX package);
7. calibration (``repro_torch.calibrate``, the reference's defaults: archs
   qwen3_32b and mamba2_780m, a logical fleet of 4 on the card), reached
   through ``repro_torch.dora.calibrate``: ``calibrate_host`` (the
   measurements, the compute factor, the step
   ratios; each kernel's launches must be the count that ``measure_host``'s
   repeats and the reduced configs' layers make), the fidelity
   suite over ``CASES`` then ``QUICK_CASES`` (each case's measured time
   beside its calibrated and uncalibrated predictions; calibration must
   lower the mean error), the regression gate against the committed
   ``calibration/h100_fidelity.json`` where it exists, traffic_monitor
   planned with ``costs="profiled:<artifact>"``, and
   ``dora.calibrate("smart_home_2")`` from the same cache (it must measure
   nothing more) with smart_home_2 planned under its factors. The artifact
   and the fidelity record go to build/calibration and are printed on one
   line;
8. the mesh and the elastic controller: h2o-danube-1.8b at full width
   (depth cut to 8 layers; batch 2 x 8192, bf16, remat="full") trained
   through ``make_train_step`` and ``TokenPipeline`` under a (1, 1)
   ("data", "model") mesh on one nccl rank (``run_ranks`` at world 1 on
   cuda:0), parameters and AdamW state laid out by ``ShardingRules`` as
   DTensors: 3 steps, a sharded async checkpoint, then the elastic
   controller remeshes onto a fresh group of generation 1, restores (bit for
   bit) and trains one more step; each DTensor step's loss and grad norm
   against the plain step from the same state (bitwise, else within the bf16
   bound), the flash forward and backward launches of the DTensor steps
   exact and the DTensor entry's local branch once a flash forward; step
   times, peak memory and the remesh time (from the verdict to the first
   resumed step's end); then the MoE, MLA, encoder-decoder and VLM models
   on a (1, 1) mesh of one nccl rank (``phase_mesh_archs``, one process
   for all four): olmoe-1b-7b at full width (2 of 16 layers, 2 x 4096, 3
   steps, the flash forward and backward launches exact), deepseek-v2-236b's
   loss and gradients (2 of 60 layers, 1 x 4096, no AdamW), whisper-small
   (2 + 2 layers, 8 x 448) and paligemma-3b (2 layers, 2 x (256 + 512)),
   one step each; each step's loss bitwise and its grad norm (deepseek:
   each gradient's norm) within ``MESH_ONE_GNORM_TOL`` of the plain step
   from the same state, the attention on the DTensor entry's local branch
   only, every expert leaf's rows whole on the one rank; then every cache
   kind served on a (1, 1) mesh of one nccl rank (``phase_serve_mesh``,
   ``SERVE_MESH_RUNS``: qwen3-32b 8 layers, h2o-danube-1.8b over its
   wrapping ring, deepseek-v2-236b's MLA latents, mamba2-780m, recurrentgemma-9b,
   olmoe-1b-7b, whisper-small's cross cache in float32, paligemma-3b's
   patches; 2 layers each otherwise) through ``launch.serve.generate``, the
   cache laid out by ``cache_specs``, against the plain serve in the same
   rank: the greedy tokens equal, the logits within phase 3's bound, the
   launches exact, every decode attention on the sharded-keys branch;
9. the examples through their ``main`` on the card: the smart-home example
   (``examples/smart_home_training_torch.py``) plans smart_home_2, trains 20
   steps and checkpoints, then resumes at step 20 and trains to 40 (no
   launch: its sequences stay below attn_chunk); the traffic-monitor example
   replays its dynamics timeline and decodes greedily, one decode launch a
   layer a step, checked exactly, its tokens equal to the same decode of CPU
   copies of its weights;
10. the dry-run (``launch/dryrun.py``) on fake "cuda" tensors
   (``phase_dryrun``): two shallow production cells on the fake (16, 16)
   mesh, no launch; h2o-danube-1.8b at 2 layers, 1 x 4096, as a dry-run on
   a fake one-rank mesh and as a real train step on the card under
   ``FlopCounterMode``, whose count must equal the dry-run's FLOPs besides
   its kernels exactly (the card's kernels are invisible to the counter);
   the dry-run's peak beside the step's ``max_memory_allocated``; the
   decode wrapper's host cost with and without its shape-only test.

The h2o, whisper and paligemma paths and recurrentgemma's training path
draw wq and wk at the fan-in of d_model (``fan_in_qk``):
with the reference init's the random model is chaotic and its gradients
explode with depth, and phases 3 and 5 print those figures beside their
own. Each phase frees its parameters and caches before the next. Every number
printed carries the card's name and power limit. The second-to-last line
is the kernels record (JSON); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; without a CUDA device, or without the repository beside
it, the script exits non-zero at once. The full record is also written to
build/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# qwen3-32b's serving shapes: batch 4, prompt 4096, 32 decode steps
DEVICE = "cuda"
BATCH, PROMPT, GEN, LAYERS = 4, 4096, 32, 8
HEADS, KV_HEADS, HEAD_DIM = 64, 8, 128
# recurrentgemma-9b's: prompt 2048 (its window), MQA, head_dim 256, lru width 4096
RG_PROMPT, RG_HEADS, RG_HEAD_DIM, RG_WIDTH = 2048, 16, 256, 4096
# mamba2-780m's SSD scan at prefill: 48 heads of 64, one group, state 128, chunk 256
SSD_HEADS, SSD_P, SSD_N, SSD_CHUNK = 48, 64, 128, 256
# qwen3-32b's training path: depth cut to 4 layers, batch 2, sequence 4096, 10 steps
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 4096, 10
# h2o-danube-1.8b's: head_dim 80, 32 heads on 8 KV heads, window 4096; it trains
# at batch 2 x 8192, above its window
H2O_HEADS, H2O_KV, H2O_HEAD_DIM, H2O_WINDOW = 32, 8, 80, 4096
H2O_TRAIN_BATCH, H2O_TRAIN_SEQ = 2, 8192
# granite-20b's group: 48 query heads on one KV head of 128
G48_HEADS = 48
# olmoe-1b-7b's attention: 16 query heads on 16 KV heads of 128 (G = 1)
OLMOE_HEADS = 16
# mamba2-780m's training path: all 48 layers, batch 4 x 4096, bf16
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 4, 4096
# recurrentgemma-9b's training path (the JAX package's train_4k shape): depth cut
# to 8 layers (two (rec, rec, local_attn) units and the two-layer rec tail),
# batch 2 x 4096 above its 2048 window, bf16
RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_SEQ = 8, 2, 4096
# whisper-small's serving path: 12 heads of 64 on 12 KV heads (G = 1); a 224-token
# prompt, the prompt half of its 448-token text context, over 1500 encoder frames
WH_PROMPT, WH_HEADS, WH_HEAD_DIM = 224, 12, 64
# paligemma-3b's: 8 heads of 256 on one KV head (G = 8); 256 patch embeddings
# before a 128-token prompt
PG_PROMPT, PG_PATCHES, PG_HEADS, PG_HEAD_DIM = 128, 256, 8, 256
# their training paths: whisper at full depth, B=8 x 448 (its text context);
# paligemma at 4 of 18 layers (the script's time), B=2 x 512 tokens after its patches
WH_TRAIN_BATCH, WH_TRAIN_SEQ = 8, 448
PG_TRAIN_LAYERS, PG_TRAIN_BATCH, PG_TRAIN_SEQ = 4, 2, 512
# olmoe-1b-7b's training path: 8 of 16 layers (AdamW's float32 state of all 16
# would not fit), batch 2 x 4096 (train_4k's sequence, above attn_chunk: the flash
# forward and backward at G = 1, d = 128), bf16
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ = 8, 2, 4096
# deepseek-v2-236b's loss and gradients (no AdamW: 2 layers' state alone is ~64 GB):
# 3 of 60 layers (the dense-first tail and two stacked MoE units), batch 1 x 4096
# (MLA's query-chunked prefill under its checkpoints), 3 timed passes
DS_GRAD_LAYERS, DS_GRAD_BATCH, DS_GRAD_SEQ, DS_GRAD_PASSES = 3, 1, 4096, 3
# calibration's steps on the reduced configs (batch 2, sequence 32, float32):
# mamba2's SSD scan (B, S, H, P, G, N, chunk) in training, and qwen3's decode
# attention (B, T, H, KV, d) at the first position of a 32-slot cache
CAL_SSD = (2, 32, 8, 32, 1, 16, 32)
CAL_DECODE = (2, 32, 8, 2, 16)
# phase 6's plans, at sequence 4096: (arch, setting, (global batch, microbatch,
# training), (t_qoe s, lambda)): granite-8b served on smart_home_2 with the serve
# launcher's workload (32 heads on 8 KV heads of 128, microbatches of 1), h2o-danube-1.8b
# trained on traffic_monitor (microbatches of 2); phase 2 holds the kernels at these
# microbatch shapes, and phase 6 checks that the plans keep them
PLAN_SEQ = 4096
PLANS = {"forward": ("granite_8b", "smart_home_2", (4, 1, False), (0.2, 100.0)),
         "gradients": ("h2o_danube_1_8b", "traffic_monitor", (8, 2, True), (8.0, 50.0))}
GRANITE_HEADS, GRANITE_KV = 32, 8
GRANITE_MB, H2O_MB = PLANS["forward"][2][1], PLANS["gradients"][2][1]


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _events_ms(torch, fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches; with ``flush``, the
    L2 cache is flushed before each launch, outside the timed span, and a
    ~0.1 ms spin kernel keeps the card busy while the host enqueues ``fn``,
    so a wrapper's host time (tens of us, as long as a decode kernel) never
    sits between the events."""
    if flush is None:
        return cuda_ms(torch, fn, reps, warmup=0)
    spans = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(200_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def paired_ms(torch, kernel, library, reps: int, rounds: int = 5, warmup: int = 3,
              flush=None):
    """A kernel and its library yardstick timed in turns: ``rounds`` rounds
    of kernel, library, library, kernel (``reps`` launches each), after
    ``warmup`` calls of both. Returns the medians over the rounds and every
    reading, so a drift of the card shows in both and not as a difference."""
    for _ in range(warmup):
        kernel()
        library()
    torch.cuda.synchronize()
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(_events_ms(torch, kernel, reps, flush))
        ls.append(_events_ms(torch, library, reps, flush))
        ls.append(_events_ms(torch, library, reps, flush))
        ks.append(_events_ms(torch, kernel, reps, flush))
    return statistics.median(ks), statistics.median(ls), dict(kernel_ms=ks, library_ms=ls)


def l2_flush(torch):
    """A callable that evicts the H100's 50 MB L2 by reading 128 MB. Reading
    leaves clean lines, as a served step's weight reads do; writing would
    leave ~50 MB of dirty lines that the timed kernel pays to write back."""
    buf = torch.ones(64 << 20, dtype=torch.bfloat16, device=DEVICE)
    return lambda: buf.amax()


def live_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that attention with this mask scores."""
    import numpy as np
    qpos = np.arange(S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(ops: float, nbytes: float, dtype: str):
    """Least time (ms) the card could take, and which rate bounds it."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# bf16 kernels are held to the plain version run in float32 on the same
# values (the exact answer up to f32 rounding), elementwise within
# BF16_RTOL * (|ref| + rms of ref's row over head_dim): four bf16 epsilons
# (2**-7 each) of the element and of its row's size. The kernel's own
# roundings (P to bf16 before P V, the output to bf16) stay under a third
# of that; a key dropped at a tile's tail in the short ragged cases, a
# window edge off by one, or a 1e-2 shift of a late row (output rms ~0.03)
# exceeds it. float32 kernels
# are held to the plain version on the same inputs within 2e-5 + 2e-5 |ref|.
BF16_RTOL = 2.0 ** -5
F32_TOL = 2e-5
# The backward's bf16 outputs also get a floor of one bf16 step at the
# output's rms: an exact cancellation makes some rows exactly 0 (causal row
# 0 of dq: P = 1 on its one key and O = V there, so dP - D = 0), where the
# kernel's dP (tensor cores) and D (CUDA cores) sum the same products in
# another order and leave f32 noise (~1e-6) against a row bound of 0.
BWD_FLOOR = 2.0 ** -9


def bound_share(torch, out, exp, dt: str, floor: float = 0.0):
    """Max abs error of ``out`` against ``exp`` and the largest share of its
    bound that any element uses; ``floor`` adds that share of ``exp``'s rms
    to every bf16 element's bound."""
    out, exp = out.float(), exp.float()
    err = (out - exp).abs()
    if dt == "bfloat16":
        row_rms = exp.pow(2).mean(dim=-1, keepdim=True).sqrt()
        bound = BF16_RTOL * (exp.abs() + row_rms) + floor * exp.pow(2).mean().sqrt()
    else:
        bound = F32_TOL + F32_TOL * exp.abs()
    return float(err.max()), float((err / bound).nan_to_num(nan=0.0, posinf=float("inf")).max())


def check(torch, out, exp, dt: str, floor: float = 0.0):
    """``bound_share`` of a finite ``out``, raising when the share is over 1."""
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("kernel output is not finite")
    err, share = bound_share(torch, out, exp, dt, floor)
    if share > 1.0:
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{err:.3e}, {share:.3g} x its bound ({TOL[dt]})")
    return err, share


TOL = {"bfloat16": "|err| <= 2**-5 (|ref| + rms_row(ref)) against float32 plain",
       "float32": "|err| <= 2e-5 + 2e-5 |ref|",
       "bfloat16 grad": "|err| <= 2**-5 (|ref| + rms_row(ref)) + 2**-9 rms(ref) against "
                        "float32 plain"}


class KernelPhase:
    """What the kernel cases share: the card, one generator, the launch
    check, and the records they fill (``rec`` by kernel, ``cases`` by case)."""

    def __init__(self, torch, card: str):
        self.torch, self.card = torch, card
        self.gen = torch.Generator(device=DEVICE).manual_seed(0)
        self.dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        self.rec, self.cases = {}, []

    def rand(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen, device=DEVICE).to(dtype)

    def launched(self, mod, fn, counter: str = "launches"):
        """Run ``fn`` once, check that it launched ``mod``'s kernel (the one
        counted by ``counter``), synchronise."""
        n0 = getattr(mod, counter)
        out = fn()
        self.torch.cuda.synchronize()
        if getattr(mod, counter) != n0 + 1:
            raise AssertionError(f"{mod.__name__}.{counter} went up by "
                                 f"{getattr(mod, counter) - n0}, not 1")
        return out

    def unpack(self):
        return self.torch, self.card, self.rec, self.cases, self.rand, self.launched, self.dtypes


def kernels_flash(kp: KernelPhase) -> None:
    """flash_attention at qwen3-32b's, recurrentgemma-9b's,
    h2o-danube-1.8b's and granite-20b's prefill shapes and phase 6's
    microbatches, ragged, windowed, head_dim 64/80/128/256, float32, and
    phase 7's calibration shape."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.calibrate import microbench as mb
    from repro_torch.kernels import ops, ref
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()
    H, KV, D = HEADS, KV_HEADS, HEAD_DIM
    Bk, Sk, Hk, KVk, Dk = mb.FLASH_SHAPE
    mains = {"main path": "flash_attention", "d256 main path": "flash_attention_d256",
             "d80 main path": "flash_attention_d80", "G=48 main path": "flash_attention_g48",
             "G=1 main path": "flash_attention_g1", "G=1 train path": "flash_attention_g1_train"}

    for name, (B, S, T, h, kv, d), causal, window, dt in [
            ("main path", (BATCH, PROMPT, PROMPT, H, KV, D), True, None, "bfloat16"),
            # recurrentgemma-9b prefill above its attn_chunk: MQA, head_dim 256, window 2048
            ("d256 main path", (BATCH, PROMPT, PROMPT, RG_HEADS, 1, RG_HEAD_DIM), True,
             RG_PROMPT, "bfloat16"),
            ("ragged S", (1, PROMPT + 1, PROMPT + 1, H, KV, D), True, None, "bfloat16"),
            ("window", (1, PROMPT // 2, PROMPT // 2, H, KV, D), True, PROMPT // 4, "bfloat16"),
            ("ragged short", (2, 200, 200, 8, 2, D), True, None, "bfloat16"),
            ("non-causal ragged d64", (2, 300, 777, 8, 2, 64), False, None, "bfloat16"),
            # S, T off the 128-row query and 64/128-key tiles; windows under a query tile
            ("ragged window 40 d256", (2, 300, 300, 4, 1, RG_HEAD_DIM), True, 40, "bfloat16"),
            ("ragged window 100", (1, 1000, 1000, 8, 2, D), True, 100, "bfloat16"),
            ("window 40 d64", (2, 257, 257, 8, 2, 64), True, 40, "bfloat16"),
            ("non-causal ragged d256", (2, 200, 333, 4, 2, RG_HEAD_DIM), False, None,
             "bfloat16"),
            ("f32 causal", (1, PROMPT // 4, PROMPT // 4, H, KV, D), True, None, "float32"),
            ("f32 non-causal ragged d64", (2, 300, 777, 8, 2, 64), False, None, "float32"),
            # h2o-danube-1.8b's prefill: head_dim 80 (the D = 128 instance, its zero
            # columns filled by the TMA), window 4096; at 8192 tokens the window binds
            ("d80 main path", (BATCH, PROMPT, PROMPT, H2O_HEADS, H2O_KV, H2O_HEAD_DIM), True,
             H2O_WINDOW, "bfloat16"),
            ("d80 window binds", (1, 2 * PROMPT, 2 * PROMPT, H2O_HEADS, H2O_KV, H2O_HEAD_DIM),
             True, H2O_WINDOW, "bfloat16"),
            ("ragged non-causal d80", (2, 300, 777, 8, 2, H2O_HEAD_DIM), False, None,
             "bfloat16"),
            ("f32 ragged window d80", (2, 300, 300, 8, 2, H2O_HEAD_DIM), True, 100, "float32"),
            # granite-20b's group: 48 query heads on one KV head
            ("G=48 main path", (BATCH, PROMPT, PROMPT, G48_HEADS, 1, D), True, None,
             "bfloat16"),
            # olmoe-1b-7b's prefill: 16 query heads on 16 KV heads (G = 1), and in
            # float32 for phase 3's decode-vs-prefill check
            ("G=1 main path", (BATCH, PROMPT, PROMPT, OLMOE_HEADS, OLMOE_HEADS, D), True, None,
             "bfloat16"),
            ("f32 G=1", (1, PROMPT // 4, PROMPT // 4, OLMOE_HEADS, OLMOE_HEADS, D), True, None,
             "float32"),
            # olmoe-1b-7b's training shape (phase 5): B = 2
            ("G=1 train path", (OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, OLMOE_TRAIN_SEQ, OLMOE_HEADS,
                                OLMOE_HEADS, D), True, None, "bfloat16"),
            # phase 6's microbatches: granite-8b's, and h2o-danube-1.8b's in bf16 and in
            # float32 (its float32 gradient check runs the CUDA-core kernel)
            ("granite-8b plan", (GRANITE_MB, PLAN_SEQ, PLAN_SEQ, GRANITE_HEADS, GRANITE_KV, D),
             True, None, "bfloat16"),
            ("d80 plan", (H2O_MB, PLAN_SEQ, PLAN_SEQ, H2O_HEADS, H2O_KV, H2O_HEAD_DIM), True,
             H2O_WINDOW, "bfloat16"),
            ("f32 d80 plan", (H2O_MB, PLAN_SEQ, PLAN_SEQ, H2O_HEADS, H2O_KV, H2O_HEAD_DIM), True,
             H2O_WINDOW, "float32"),
            # phase 7's calibration: kernel_rates' shape
            ("f32 calibration rate", (Bk, Sk, Sk, Hk, KVk, Dk), True, None, "float32")]:
        q, k, v = rand((B, S, h, d), dtypes[dt]), rand((B, T, kv, d), dtypes[dt]), \
            rand((B, T, kv, d), dtypes[dt])
        out = launched(kernels.flash_attention,
                       lambda: ops.flash_attention(q, k, v, causal=causal, window=window))

        def plain(q=q, k=k, v=v):  # a batch row at a time: all rows' (S, T) scores do not fit
            return torch.cat([ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                      causal=causal, window=window)
                              for i in range(B)])
        exp = plain(q.float(), k.float(), v.float())
        err, share = check(torch, out, exp, dt)
        cases_out.append(dict(kernel="flash_attention", case=name, dtype=dt, max_abs_err=err,
                          bound_share=share, tol=TOL[dt]))
        log(card, f"flash_attention {name}: B={B} S={S} T={T} H={h} KV={kv} d={d} {dt} "
                  f"window={window} causal={causal}: max abs err {err:.3e}, worst element "
                  f"at {share:.3f} of its bound ({TOL[dt]})")
        if name in mains:
            live = live_pairs(S, T, causal, window)      # scored pairs per (b, h)
            ops_n = 4.0 * B * h * d * live               # QK^T and PV, 2 ops per MAC
            nbytes = 2 * (2 * B * S * h * d + 2 * B * T * kv * d)
            bound_ms, bound_by = bound(ops_n, nbytes, dt)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            if window is None or window >= S:     # a window as long as S masks no key
                def library():
                    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                          enable_gqa=True)
            else:
                qpos = torch.arange(S, device=DEVICE)[:, None]
                kpos = torch.arange(T, device=DEVICE)[None, :]
                mask = kpos > qpos - window
                if causal:
                    mask = mask & (kpos <= qpos)

                def library():
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          enable_gqa=True)
            ms, lib_ms, readings = paired_ms(
                torch, lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                library, reps=3, rounds=3, warmup=1)
            plain_ms = cuda_ms(torch, plain, reps=2)
            rec[mains[name]] = dict(
                shape=dict(B=B, S=S, T=T, H=h, KV=kv, d=d, dtype=dt, causal=causal,
                           window=window),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops_n, bytes=nbytes, max_abs_err=err,
                bound_share=share, tol=TOL[dt], timing=readings)
        del q, k, v, out, exp
    for key, what in (("flash_attention", "the main path's shape"),
                      ("flash_attention_d256", "recurrentgemma-9b's d=256 prefill shape"),
                      ("flash_attention_d80", "h2o-danube-1.8b's d=80 prefill shape"),
                      ("flash_attention_g48", "granite-20b's G=48 prefill shape"),
                      ("flash_attention_g1", "olmoe-1b-7b's G=1 prefill shape"),
                      ("flash_attention_g1_train", "olmoe-1b-7b's G=1 training shape")):
        r = rec[key]
        log(card, f"flash_attention at {what}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention "
                  f"{r['library_ms']:.3f} ms (medians of turns), bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']})")
    torch.cuda.empty_cache()


def kernels_decode(kp: KernelPhase) -> None:
    """decode_attention at qwen3-32b's, recurrentgemma-9b's,
    h2o-danube-1.8b's (head_dim 80), granite-20b's (G = 48), olmoe-1b-7b's
    (G = 1), whisper-small's (head_dim 64, G = 1) and paligemma-3b's (head_dim
    256, G = 8) decode shapes, phase 7's calibration shapes (head_dim 64
    and 16) and the traffic-monitor example's (head_dim 16, float32)."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.calibrate import microbench as mb
    from repro_torch.kernels import ops, ref
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()
    H, KV, D = HEADS, KV_HEADS, HEAD_DIM
    Bk, _, Hk, KVk, Dk = mb.FLASH_SHAPE
    flush = l2_flush(torch)      # a served step finds the cache cold

    def run_decode(key, main, cases):
        for name, (B, t, h, kv, d), lens, window, dt in cases:
            q = rand((B, 1, h, d), dtypes[dt])
            kc, vc = rand((B, t, kv, d), dtypes[dt]), rand((B, t, kv, d), dtypes[dt])
            cl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            out = launched(kernels.decode_attention,
                           lambda: ops.decode_attention(q, kc, vc, cl, window=window))
            exp = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), cl, window=window)
            exp[cl == 0] = 0.0    # no live key: the kernels write 0 (a softmax would average)
            err, share = check(torch, out, exp, dt)
            split_len, n_splits = kernels.decode_attention.split_plan(t, B, kv, h // kv)
            cases_out.append(dict(kernel="decode_attention", case=name, dtype=dt,
                                  max_abs_err=err, bound_share=share, tol=TOL[dt],
                                  split_len=split_len, n_splits=n_splits))
            log(card, f"decode_attention {name}: B={B} T={t} H={h} KV={kv} d={d} {dt} "
                      f"lens={lens} window={window}, {n_splits} splits of {split_len}: max abs "
                      f"err {err:.3e}, worst element at {share:.3f} of its bound ({TOL[dt]})")
            if name == main:
                live = sum(min(n, t) for n in lens)      # cache rows the lengths make live
                elt = 2 if dt == "bfloat16" else 4
                nbytes = elt * (2 * live * kv * d + 2 * B * h * d) + 4 * B
                ops_n = 4.0 * h * d * live
                bound_ms, bound_by = bound(ops_n, nbytes, dt)
                mask = (torch.arange(t, device=DEVICE)[None, :] < cl[:, None])[:, None, None, :]
                qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
                ms, lib_ms, readings = paired_ms(
                    torch, lambda: ops.decode_attention(q, kc, vc, cl),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                           enable_gqa=True),
                    reps=20, rounds=5, flush=flush)
                plain_ms = cuda_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, cl),
                                   reps=20)
                rec[key] = dict(
                    shape=dict(B=B, T=t, H=h, KV=kv, d=d, dtype=dt, cache_len=lens,
                               split_len=split_len, n_splits=n_splits),
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by, ops=ops_n, bytes=nbytes, max_abs_err=err,
                    bound_share=share, tol=TOL[dt], timing=readings, l2="flushed")
            del q, kc, vc, out, exp
        r = rec[key]
        log(card, f"decode_attention at {main}'s shape: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"{r['library_ms']:.4f} ms (medians of turns, L2 flushed before each "
                  f"launch), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    T = PROMPT + GEN
    run_decode("decode_attention", "main path", [
        ("main path", (BATCH, T, H, KV, D), [T] * BATCH, None, "bfloat16"),
        ("per-batch lengths", (4, T, H, KV, D), [T, PROMPT + 1, PROMPT // 4, 1], None,
         "bfloat16"),
        ("window", (4, T, H, KV, D), [T, 3 * T // 4, T // 8, 17], T // 4, "bfloat16"),
        # most splits hold no live key (lengths 1 and 0); a row of length 0 is zeros
        ("empty splits", (4, T, H, KV, D), [T, 1, 0, T - 1], None, "bfloat16"),
        ("T=300 MQA d64", (3, 300, 8, 1, 64), [300, 101, 7], 96, "bfloat16"),
        ("one split T=32", (3, 32, 8, 1, 64), [32, 5, 1], 8, "bfloat16"),
        ("f32", (2, T, H, KV, D), [T, PROMPT // 2 + 1], None, "float32"),
        ("f32 empty splits", (4, T, H, KV, D), [T, 1, 0, T - 1], None, "float32"),
        ("f32 T=300 MQA d64", (3, 300, 8, 1, 64), [300, 101, 7], 96, "float32"),
        # phase 7's calibration: kernel_rates' shape, a full cache
        ("f32 calibration rate", (Bk, mb.DECODE_T, Hk, KVk, Dk), [mb.DECODE_T] * Bk, None,
         "float32")])
    # recurrentgemma-9b's local attention: a full 2048-slot ring, MQA, head_dim 256
    Tr, Hr, Dr = RG_PROMPT, RG_HEADS, RG_HEAD_DIM
    run_decode("decode_attention_d256", "d256 main path", [
        ("d256 main path", (BATCH, Tr, Hr, 1, Dr), [Tr] * BATCH, None, "bfloat16"),
        ("d256 ring lengths", (4, Tr, Hr, 1, Dr), [Tr, Tr - 255, 256, 1], None, "bfloat16"),
        ("d256 window", (4, Tr, Hr, 1, Dr), [Tr, 3 * Tr // 4, 100, 17], Tr // 4, "bfloat16"),
        ("d256 GQA T=300", (3, 300, 8, 2, Dr), [300, 101, 7], 96, "bfloat16"),
        ("d256 f32", (2, Tr, Hr, 1, Dr), [Tr, Tr // 2 + 1], None, "float32")])
    # h2o-danube-1.8b's: head_dim 80, 32 heads on 8 KV heads
    Hh, KVh, Dh = H2O_HEADS, H2O_KV, H2O_HEAD_DIM
    run_decode("decode_attention_d80", "d80 main path", [
        ("d80 main path", (BATCH, T, Hh, KVh, Dh), [T] * BATCH, None, "bfloat16"),
        ("d80 window", (4, T, Hh, KVh, Dh), [T, 3 * T // 4, 100, 0], T // 4, "bfloat16"),
        ("d80 T=300 MQA", (3, 300, 8, 1, Dh), [300, 101, 7], 96, "bfloat16"),
        ("d80 f32", (2, T, Hh, KVh, Dh), [T, PROMPT // 2 + 1], None, "float32"),
        ("d80 f32 empty splits", (4, T, Hh, KVh, Dh), [T, 1, 0, T - 1], None, "float32")])
    # the reduced dense configs' head_dim 16: calibration's decode step (float32,
    # position 0 of a 32-slot cache), then longer caches in both types
    Bc, Tc, Hc, KVc, Dc = CAL_DECODE
    run_decode("decode_attention_d16", "d16 main path", [
        ("d16 main path", (Bc, Tc, Hc, KVc, Dc), [1] * Bc, None, "float32"),
        ("d16 f32", (2, T, Hc, KVc, Dc), [T, 17], None, "float32"),
        ("d16 f32 window", (3, 300, Hc, KVc, Dc), [300, 101, 0], 96, "float32"),
        ("d16 bf16", (4, T, Hc, KVc, Dc), [T, PROMPT + 1, 100, 1], None, "bfloat16"),
        ("d16 bf16 window", (3, 300, Hc, KVc, Dc), [300, 101, 7], 96, "bfloat16"),
        # the traffic-monitor example's cache: lengths 17 (the warm-up step) to 48
        ("d16 traffic example first step", TRAFFIC_DECODE, [17] * 4, None, "float32"),
        ("d16 traffic example", TRAFFIC_DECODE, [48, 17, 33, 40], None, "float32")])
    # granite-20b's group: 48 query heads on one KV head of 128
    run_decode("decode_attention_g48", "G=48 main path", [
        ("G=48 main path", (BATCH, T, G48_HEADS, 1, D), [T] * BATCH, None, "bfloat16"),
        ("G=48 f32", (2, T, G48_HEADS, 1, D), [T, 17], None, "float32")])
    # olmoe-1b-7b's: 16 query heads on 16 KV heads, one of the 16 mma rows of a
    # KV head's tile live (G = 1); float32 for phase 3's check
    Ho = OLMOE_HEADS
    run_decode("decode_attention_g1", "G=1 main path", [
        ("G=1 main path", (BATCH, T, Ho, Ho, D), [T] * BATCH, None, "bfloat16"),
        ("G=1 lengths", (4, T, Ho, Ho, D), [T, PROMPT + 1, 100, 0], None, "bfloat16"),
        ("G=1 f32", (2, T, Ho, Ho, D), [T, PROMPT // 2 + 1], None, "float32")])
    # whisper-small's decoder self-attention: 12 heads of 64 on 12 KV heads (G = 1)
    # over its served 256-slot cache (prompt 224 + 32 steps)
    Tw, Hw, Dw = WH_PROMPT + GEN, WH_HEADS, WH_HEAD_DIM
    run_decode("decode_attention_whisper", "whisper main path", [
        ("whisper main path", (BATCH, Tw, Hw, Hw, Dw), [Tw] * BATCH, None, "bfloat16"),
        ("whisper lengths", (4, Tw, Hw, Hw, Dw), [Tw, WH_PROMPT + 1, 17, 0], None, "bfloat16"),
        ("whisper f32", (2, Tw, Hw, Hw, Dw), [Tw, WH_PROMPT + 1], None, "float32")])
    # paligemma-3b's: 8 heads of 256 on one KV head (G = 8) over its served 416-slot
    # cache (256 patches + prompt 128 + 32 steps)
    Tp, Hp, Dp = PG_PATCHES + PG_PROMPT + GEN, PG_HEADS, PG_HEAD_DIM
    run_decode("decode_attention_paligemma", "paligemma main path", [
        ("paligemma main path", (BATCH, Tp, Hp, 1, Dp), [Tp] * BATCH, None, "bfloat16"),
        ("paligemma lengths", (4, Tp, Hp, 1, Dp), [Tp, PG_PATCHES + 1, 100, 0], None,
         "bfloat16"),
        ("paligemma f32", (2, Tp, Hp, 1, Dp), [Tp, PG_PATCHES + PG_PROMPT + 1], None,
         "float32")])
    del flush
    torch.cuda.empty_cache()


# decode_attention's sharded-keys mode: a cache cut into this many shards (the
# "model" axis of a (1, 4) mesh), each shard's (o, lse) held to its plain version
PARTIAL_SHARDS = 4


def merge_on_one_card(torch, parts):
    """``ops.merge_partials``' rule over the partials ``[(o (B,1,H,d), lse
    (B,H))]`` of one process: the output over every shard's keys, float32."""
    from repro_torch.kernels.decode_attention import NEG_INF
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])[:, :, None]
    w = torch.where(lse > NEG_INF, torch.exp(lse - lse.amax(dim=0)), 0.0)[..., None]
    num, den = (w * o).sum(dim=0), w.sum(dim=0)
    return torch.where(den > 0, num / den.clamp(min=1e-30), 0.0)


def kernels_decode_partial(kp: KernelPhase) -> None:
    """decode_attention's sharded-keys mode (``decode_attention_partial``)
    at qwen3-32b's decode shape (B 4, T 4128 cut into 4 shards of 1032 at
    offsets 0 / 1032 / 2064 / 3096) and at h2o-danube-1.8b's d = 80 with its
    4096 window (T 8256 in 4 shards of 2064), with lengths that end inside a
    shard, past a shard's end (cache_len - kv_offset > Tk) and below the
    window, and shards with no live key: each shard's o (bf16 bound) and lse
    (float32 tolerance) against ``decode_attention_partial_ref``, then the
    four shards merged on the card against the one-card kernel on the
    whole cache (bf16 bound) and the float32 plain version; and the partial
    call on a quarter shard of the main shape (every key live) timed beside
    the whole-cache call, with its byte bound and the efficient sdpa kernel
    with ``compute_log_sumexp=True`` on the shard (K/V repeated over the
    group) as a yardstick."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()
    T = PROMPT + GEN
    bf16 = torch.bfloat16
    for name, (B, t, h, kv, d), lens, window in [
            ("sharded keys main path", (BATCH, T, HEADS, KV_HEADS, HEAD_DIM), [T, 3000, 1100, 17],
             None),
            ("sharded keys d80 window", (4, 2 * T, H2O_HEADS, H2O_KV, H2O_HEAD_DIM),
             [2 * T, 5000, 2100, 1], H2O_WINDOW)]:
        q = rand((B, 1, h, d), bf16)
        kc, vc = rand((B, t, kv, d), bf16), rand((B, t, kv, d), bf16)
        cl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        n = t // PARTIAL_SHARDS
        parts = []
        for i in range(PARTIAL_SHARDS):
            a = i * n
            ks, vs = kc[:, a:a + n].contiguous(), vc[:, a:a + n].contiguous()
            o, lse = launched(dec, lambda: dec.decode_attention_partial(
                q, ks, vs, cl, kv_offset=a, window=window))
            exp_o, exp_lse = dec.decode_attention_partial_ref(q.float(), ks.float(), vs.float(),
                                                              cl, kv_offset=a, window=window)
            err, share = check(torch, o, exp_o, "bfloat16")
            lerr, lshare = check(torch, lse, exp_lse, "float32")
            cases_out.append(dict(kernel="decode_attention", case=f"{name} shard {i}",
                                  dtype="bfloat16", max_abs_err=err, bound_share=share,
                                  lse_max_abs_err=lerr, lse_bound_share=lshare, tol=TOL["bfloat16"],
                                  kv_offset=a))
            log(card, f"decode_attention_partial {name} shard {i} (keys {a}..{a + n}): B={B} "
                      f"H={h} KV={kv} d={d} lens={lens} window={window}: o max abs err "
                      f"{err:.3e} at {share:.3f} of its bound ({TOL['bfloat16']}), lse max abs "
                      f"err {lerr:.3e} at {lshare:.3f} of its bound ({TOL['float32']})")
            parts.append((o, lse))
            del ks, vs
        merged = merge_on_one_card(torch, parts)
        one = launched(dec, lambda: ops.decode_attention(q, kc, vc, cl, window=window))
        exp = dec.decode_attention_ref(q.float(), kc.float(), vc.float(), cl, window=window)
        exp[cl == 0] = 0.0
        err1, share1 = check(torch, merged, one.float(), "bfloat16")
        err2, share2 = check(torch, merged, exp, "bfloat16")
        cases_out.append(dict(kernel="decode_attention", case=f"{name} merged", dtype="bfloat16",
                              max_abs_err=err2, bound_share=share2, vs_one_card_err=err1,
                              vs_one_card_share=share1, tol=TOL["bfloat16"]))
        log(card, f"decode_attention_partial {name}: {PARTIAL_SHARDS} shards merged by "
                  f"log-sum-exp against the one-card kernel on the whole cache: max abs err "
                  f"{err1:.3e} at {share1:.3f} of the bf16 bound; against the float32 plain "
                  f"version {err2:.3e} at {share2:.3f}")
        del q, kc, vc, parts, merged, one, exp

    # a quarter shard of the main shape, every key live, timed beside the whole cache
    B, h, kv, d = BATCH, HEADS, KV_HEADS, HEAD_DIM
    n = T // PARTIAL_SHARDS
    q = rand((B, 1, h, d), bf16)
    kc, vc = rand((B, T, kv, d), bf16), rand((B, T, kv, d), bf16)
    ks, vs = kc[:, :n].contiguous(), vc[:, :n].contiguous()
    cl = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1).contiguous() for x in (ks, vs))
    o, lse = dec.decode_attention_partial(q, ks, vs, cl, kv_offset=0)
    err, share = check(torch, o, dec.decode_attention_partial_ref(
        q.float(), ks.float(), vs.float(), cl, kv_offset=0)[0], "bfloat16")
    flush = l2_flush(torch)
    ms, lib_ms, readings = paired_ms(
        torch, lambda: dec.decode_attention_partial(q, ks, vs, cl, kv_offset=0),
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(qt, kt, vt, None, True),
        reps=20, rounds=5, flush=flush)
    whole_ms = _events_ms(torch, lambda: ops.decode_attention(q, kc, vc, cl), 20, flush)
    plain_ms = cuda_ms(torch, lambda: dec.decode_attention_partial_ref(q, ks, vs, cl,
                                                                       kv_offset=0), reps=20)
    live = B * n
    nbytes = 2 * (2 * live * kv * d + B * h * d) + 4 * (B * h * d + B * h) + 4 * B
    ops_n = 4.0 * h * d * live
    bound_ms, bound_by = bound(ops_n, nbytes, "bfloat16")
    rec["decode_attention_partial"] = dict(
        shape=dict(B=B, T_shard=n, T=T, H=h, KV=kv, d=d, dtype="bfloat16", kv_offset=0,
                   cache_len=[T] * B, shards=PARTIAL_SHARDS),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
        ops=ops_n, bytes=nbytes, max_abs_err=err, bound_share=share, tol=TOL["bfloat16"],
        whole_cache_ms=whole_ms, timing=readings, l2="flushed",
        library="aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True), "
                "K/V repeated over the group")
    log(card, f"decode_attention_partial on a quarter shard of the main shape ({n} of {T} keys, "
              f"all live): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, efficient sdpa with lse "
              f"{lib_ms:.4f} ms (medians of turns, L2 flushed before each launch), bound "
              f"{bound_ms:.4f} ms ({bound_by}); the whole-cache call {whole_ms:.4f} ms")
    del q, kc, vc, ks, vs, kt, vt, flush
    torch.cuda.empty_cache()


SSD_STAGES = ("ssd_cb_kernel", "ssd_chunk_state_kernel", "ssd_state_passing_kernel",
              "ssd_chunk_scan_kernel")


def ssd_stage_bytes(B: int, S: int, H: int, P: int, G: int, N: int, L: int) -> Dict[str, int]:
    """Device-memory bytes each bf16 stage must move (each input read once,
    each output written once): the decomposition's own traffic, with its
    scratch (cb's lower 64x64 tiles in f32, a_cum, the f32 chunk states,
    prev in bf16) written by one stage and read by the next."""
    nc, nt = S // L, -(-L // 64)
    xb, bcb, ab = 2 * B * S * H * P, 2 * B * S * G * N, 4 * B * S * H
    cb = 4 * B * nc * G * (nt * (nt + 1) // 2) * 64 * 64
    states, prev, final = 4 * B * nc * H * P * N, 2 * B * nc * H * P * N, 4 * B * H * P * N
    return {"ssd_cb_kernel": 2 * bcb + cb,
            "ssd_chunk_state_kernel": xb + bcb + ab + states + ab,
            "ssd_state_passing_kernel": states + 4 * B * H * nc + prev + final,
            "ssd_chunk_scan_kernel": xb + ab + bcb + cb + prev + xb}


def kernels_ssd(kp: KernelPhase) -> None:
    """ssd_scan at mamba2-780m's prefill shape, grouped, ragged chunk, phase
    7's calibration shapes. bf16 runs the four chunk-parallel stages (cb,
    chunk_state, state_passing, chunk_scan), float32 the CUDA-core kernel."""
    from repro_torch import kernels
    from repro_torch.calibrate import microbench as mb
    from repro_torch.kernels import ops, ref
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()

    # inputs as tests/test_kernels.py draws them: x, b, c ~ N(0, 0.01), a_log = -0.1 |N(0, 1)|
    for name, (B, S, h, P, G, N, L), dt in [
            ("main path", (BATCH, PROMPT, SSD_HEADS, SSD_P, 1, SSD_N, SSD_CHUNK), "bfloat16"),
            ("grouped f32", (2, 512, 8, 32, 2, 64, 128), "float32"),
            ("chunk 100 f32", (1, 300, 4, 64, 1, 32, 100), "float32"),
            ("chunk 100 bf16", (1, 300, 4, 64, 1, 32, 100), "bfloat16"),
            ("grouped bf16 P48 N80", (2, 192, 8, 48, 2, 80, 48), "bfloat16"),
            # phase 7's calibration: kernel_rates' shape, and the reduced mamba2 train step's
            ("f32 calibration rate", mb.SSD_SHAPE + (mb.SSD_CHUNK,), "float32"),
            ("f32 calibration step", CAL_SSD, "float32")]:
        x = (rand((B, S, h, P), torch.float32) * 0.1).to(dtypes[dt])
        a = -rand((B, S, h), torch.float32).abs() * 0.1
        b = (rand((B, S, G, N), torch.float32) * 0.1).to(dtypes[dt])
        c = (rand((B, S, G, N), torch.float32) * 0.1).to(dtypes[dt])
        y, st = launched(kernels.ssd_scan, lambda: ops.ssd_scan(x, a, b, c, chunk=L))
        ye, se = ref.ssd_scan_ref(x.float(), a, b.float(), c.float(), L)
        err, share = check(torch, y, ye, dt)
        err_s, share_s = check(torch, st, se, "float32")
        cases_out.append(dict(kernel="ssd_scan", case=name, dtype=dt, max_abs_err=err,
                              bound_share=share, tol=TOL[dt], state_max_abs_err=err_s,
                              state_bound_share=share_s, state_tol=TOL["float32"]))
        log(card, f"ssd_scan {name}: B={B} S={S} H={h} P={P} G={G} N={N} chunk={L} {dt}: "
                  f"y max abs err {err:.3e}, worst element at {share:.3f} of its bound "
                  f"({TOL[dt]}); final state (f32) {err_s:.3e}, {share_s:.3f} of its bound "
                  f"({TOL['float32']})")
        if name == "main path":
            elt = 2
            nbytes = elt * (2 * B * S * h * P + 2 * B * S * G * N) + 4 * B * S * h \
                + 4 * B * h * P * N
            # the least work of the function per chunk: C B^T once per group over the
            # causal (query, key) pairs; per head the masked, decayed scores times X over
            # the same pairs, C prev^T and the chunk's state X^T B (bf16 products); the
            # decays of the scores (exp, multiply) and the state recurrence in f32
            nc, pairs = S // L, L * (L + 1) // 2
            ops_n = 2.0 * B * nc * (G * pairs * N + h * (pairs * P + 2 * L * N * P))
            ops_f32 = 2.0 * B * nc * h * (pairs + P * N)
            t_ops = ops_n / PEAK_OPS[dt] + ops_f32 / PEAK_OPS["float32"]
            t_bytes = nbytes / HBM_BYTES_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            # for comparison with earlier rows: the TPU kernel's count per (b, h, chunk)
            # (C B^T for every head, full L x L products), which bounded PR 12's kernel
            tpu_ops = 2.0 * B * h * nc * (L * L * N + L * L * P + 2 * L * N * P)
            stage_bytes = ssd_stage_bytes(B, S, h, P, G, N, L)
            design_traffic_ms = sum(stage_bytes.values()) / HBM_BYTES_S * 1e3

            def plain():
                return ref.ssd_scan_ref(x, a, b, c, L)
            ms, plain_ms, readings = paired_ms(
                torch, lambda: ops.ssd_scan(x, a, b, c, chunk=L), plain, reps=10, rounds=3,
                warmup=1)
            # each stage's device time, from the profiler over 5 calls
            def five():
                for _ in range(5):
                    ops.ssd_scan(x, a, b, c, chunk=L)
            stages = {k: 0.0 for k in SSD_STAGES}
            for e in device_window(torch, card, five, cpu=False)[0]:
                for k in SSD_STAGES:
                    if f"{k}(" in e.key:
                        stages[k] += e.self_device_time_total / 1e3 / 5
            if not all(v > 0 for v in stages.values()):
                raise AssertionError(f"the profiler saw no device time for a stage: {stages}")
            rec["ssd_scan"] = dict(
                shape=dict(B=B, S=S, H=h, P=P, G=G, N=N, chunk=L, dtype=dt),
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops_n, ops_f32=ops_f32, bytes=nbytes,
                max_abs_err=max(err, err_s), bound_share=max(share, share_s),
                tol=f"y: {TOL[dt]}; state: {TOL['float32']}",
                timing=dict(kernel_ms=readings["kernel_ms"], plain_ms=readings["library_ms"]),
                stages_ms=stages, tpu_ops=tpu_ops, tpu_ops_ms=tpu_ops / PEAK_OPS[dt] * 1e3,
                stage_bytes=stage_bytes, design_bytes=sum(stage_bytes.values()),
                design_traffic_ms=design_traffic_ms)
            for k in SSD_STAGES:
                log(card, f"ssd_scan stage {k}: {stages[k]:.4f} ms on the device (profiler, mean "
                          f"of 5 calls); it moves {stage_bytes[k] / 1e6:.1f} MB, "
                          f"{stage_bytes[k] / HBM_BYTES_S * 1e3:.4f} ms at the HBM rate")
        del x, a, b, c, y, st, ye, se
    r = rec["ssd_scan"]
    log(card, f"ssd_scan at the main path's shape (bf16): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms (medians of turns), no single PyTorch call computes it, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB in and "
              f"out; {r['ops'] / 1e9:.2f} GFLOP bf16 + {r['ops_f32'] / 1e9:.3f} GFLOP f32); the "
              f"TPU kernel's count, {r['tpu_ops'] / 1e9:.1f} GFLOP, would take "
              f"{r['tpu_ops_ms']:.4f} ms; the four stages' own traffic, scratch included, "
              f"{r['design_bytes'] / 1e9:.3f} GB, would take {r['design_traffic_ms']:.4f} ms")
    torch.cuda.empty_cache()


# the bf16 backward's kernels, in launch order (float32 keeps ssd_bwd_state_kernel,
# ssd_bwd_passing_kernel and ssd_bwd_chunk_kernel on the CUDA cores)
SSD_BWD_STAGES = ("ssd_bwd_chunk_state_kernel", "ssd_bwd_state_passing_kernel",
                  "ssd_bwd_dcb_kernel", "ssd_bwd_dx_kernel", "ssd_bwd_dbdc_kernel",
                  "ssd_bwd_da_kernel")
# (name, (B, S, H, P, G, N, chunk), dtype, with the final state's cotangent): the
# first is mamba2-780m's training shape, the second the reduced mamba2 train step
# that calibration times
SSD_BWD_CASES = [
    ("train path", (MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, SSD_HEADS, SSD_P, 1, SSD_N, SSD_CHUNK),
     "bfloat16", False),
    ("calibration f32", CAL_SSD, "float32", False),
    ("grouped f32 state", (2, 512, 8, 32, 2, 64, 128), "float32", True),
    ("chunk 100 bf16 state", (1, 300, 4, 64, 4, 32, 100), "bfloat16", True),
    ("f32 P64 N128 chunk 256", (1, 1024, 4, SSD_P, 1, SSD_N, SSD_CHUNK), "float32", True),
    # two groups of four heads: db and dc summed over each group's heads
    ("grouped bf16 state", (2, 512, 8, 32, 2, 64, 128), "bfloat16", True),
    ("grouped bf16 P64 N128 chunk 256", (1, 1024, 8, SSD_P, 2, SSD_N, SSD_CHUNK), "bfloat16",
     True)]


def ssd_bwd_ops(B: int, S: int, H: int, P: int, G: int, N: int, L: int) -> float:
    """The backward's least work, 2 operations a multiply-add: per group and
    chunk three L x L x N products over the causal (query, key) pairs (C B^T,
    dC = dcb B, dB = dcb^T C, with dcb the group's heads' (dy X^T) o lmat
    summed first); per head two L x L x P products over the same pairs (dy
    X^T, dx) and the five L x P x N state products (the chunk's state, dy's
    share of d prev, B dst^T, X dst, dy prev)."""
    nc, pairs = S // L, L * (L + 1) // 2
    return 2.0 * B * nc * (3 * G * pairs * N + H * (2 * pairs * P + 5 * L * P * N))


def ssd_bwd_ops_per_head(B: int, S: int, H: int, P: int, G: int, N: int, L: int) -> float:
    """The float32 CUDA-core design's own count: C B^T once per group, the dC
    and dB products per head."""
    nc, pairs = S // L, L * (L + 1) // 2
    return 2.0 * B * nc * (G * pairs * N + H * (pairs * (2 * P + 2 * N) + 5 * L * P * N))


def kernels_ssd_bwd(kp: KernelPhase) -> None:
    """ssd_scan_bwd at mamba2-780m's training shape and the reduced calibration
    step's, grouped, ragged chunk, with and without the final state's
    cotangent; against ssd_scan_bwd_ref on the same values in float32."""
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()
    mod = kernels.ssd_scan
    for name, (B, S, h, P, G, N, L), dt, with_state in SSD_BWD_CASES:
        x = (rand((B, S, h, P), torch.float32) * 0.1).to(dtypes[dt])
        a = -rand((B, S, h), torch.float32).abs() * 0.1
        b = (rand((B, S, G, N), torch.float32) * 0.1).to(dtypes[dt])
        c = (rand((B, S, G, N), torch.float32) * 0.1).to(dtypes[dt])
        dy = rand((B, S, h, P), dtypes[dt])
        dst = rand((B, h, P, N), torch.float32) if with_state else None
        got = launched(mod, lambda: ops.ssd_scan_bwd(x, a, b, c, dy, dst, chunk=L),
                       "bwd_launches")
        exp = ref.ssd_scan_bwd_ref(x.float(), a, b.float(), c.float(), dy.float(), dst, L)
        # da_log is float32 whatever the input type: the float32 tolerance
        errs = {n: check(torch, g, e, dt if n != "da_log" else "float32")
                for n, g, e in zip(("dx", "da_log", "db", "dc"), got, exp)}
        err, share = max(e for e, _ in errs.values()), max(sh for _, sh in errs.values())
        tol = f"dx, db, dc: {TOL[dt]}; da_log: {TOL['float32']}"
        cases_out.append(dict(kernel="ssd_scan_bwd", case=name, dtype=dt, max_abs_err=err,
                              bound_share=share, tol=tol,
                              by_output={n: dict(max_abs_err=e, bound_share=sh)
                                         for n, (e, sh) in errs.items()}))
        log(card, f"ssd_scan_bwd {name}: B={B} S={S} H={h} P={P} G={G} N={N} chunk={L} {dt}, "
                  f"final-state cotangent {'yes' if with_state else 'none'}: "
                  + ", ".join(f"{n} max abs err {e:.3e} at {sh:.3f} of its bound"
                              for n, (e, sh) in errs.items()) + f" ({tol})")
        if name == "train path":
            elt = 2
            # x, dy read and dx written; b, c read and db, dc written; a_log read, da_log written
            nbytes = elt * (3 * B * S * h * P + 4 * B * S * G * N) + 2 * 4 * B * S * h
            ops_n = ssd_bwd_ops(B, S, h, P, G, N, L)
            ops_head = ssd_bwd_ops_per_head(B, S, h, P, G, N, L)
            bound_ms, bound_by = bound(ops_n, nbytes, dt)
            ms = cuda_ms(torch, lambda: ops.ssd_scan_bwd(x, a, b, c, dy, None, chunk=L), reps=5)
            plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_bwd_ref(x, a, b, c, dy, None, L),
                               reps=1)

            def three():
                for _ in range(3):
                    ops.ssd_scan_bwd(x, a, b, c, dy, None, chunk=L)
            stages = {k: 0.0 for k in SSD_BWD_STAGES}
            for e in device_window(torch, card, three, cpu=False)[0]:
                for k in SSD_BWD_STAGES:
                    if f"{k}<" in e.key or f"{k}(" in e.key:
                        stages[k] += e.self_device_time_total / 1e3 / 3
            if not all(v > 0 for v in stages.values()):
                raise AssertionError(f"the profiler saw no device time for a stage: {stages}")
            rec["ssd_scan_bwd"] = dict(
                shape=dict(B=B, S=S, H=h, P=P, G=G, N=N, chunk=L, dtype=dt),
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                ops=ops_n, ops_per_head=ops_head,
                ops_per_head_ms=ops_head / PEAK_OPS[dt] * 1e3, bytes=nbytes, max_abs_err=err,
                bound_share=share, tol=tol, stages_ms=stages)
            for k in SSD_BWD_STAGES:
                log(card, f"ssd_scan_bwd stage {k}: {stages[k]:.4f} ms on the device (profiler, "
                          f"mean of 3 calls)")
        del x, a, b, c, dy, dst, got, exp
        torch.cuda.empty_cache()
    r = rec["ssd_scan_bwd"]
    worst = max((cs for cs in cases_out if cs["kernel"] == "ssd_scan_bwd"),
                key=lambda cs: cs["bound_share"])
    log(card, f"ssd_scan_bwd at the training path's shape (bf16): kernels {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, no single PyTorch call computes it, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['ops'] / 1e9:.1f} GFLOP, "
              f"{r['bytes'] / 1e6:.1f} MB); the per-head count, {r['ops_per_head'] / 1e9:.1f} "
              f"GFLOP, would take {r['ops_per_head_ms']:.4f} ms; the worst case's share of its "
              f"bound {worst['bound_share']:.3f} ({worst['case']})")


# a carried state: decay near one (a ~ 0.999 a step) and none at all (h the
# running sum of b) carry a state across the forward kernel's 128-step rounds
# for ~1000 steps or for ever, where a_log = -0.5 |N(0, 1)| forgets it within
# ~40. Such an h crosses zero while its float32 rounding error grows with
# ~eps sqrt(t) x the channel's size, so the kernel and the plain version are
# each held to a float64 run of the recurrence at 2e-5 of (|h| + the
# channel's rms over the sequence); a wrong carry is off by the size of h.
# The run takes the decays exp(a_log) as both compute them, in float32 on
# the card: near 0 that exp rounds up on average (the near-one case prints
# its mean error; ~0.25 ulp on an H100), and over a near-one decay's
# ~1000-step memory the bias alone moves h by about this bound, for kernel
# and plain version alike. The share against a run on the exact decays is
# printed beside it.
RG_CARRY_TOL = ("|err| <= 2e-5 + 2e-5 (|ref| + rms_t(ref)) against a float64 run on the "
                "float32 decays")
RG_CARRY_DECAYS = [("near-one decay", 1e-3), ("no decay", 0.0)]
RG_CARRY_SHAPES = [("train path", (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH)),
                   ("S off a round", (RG_TRAIN_BATCH, RG_TRAIN_SEQ + 77, RG_WIDTH)),
                   ("S below a piece", (2, 9, 512)), ("S 1", (2, 1, 512)),
                   ("W 200 off the tile", (3, 1100, 200)), ("B 1", (1, RG_TRAIN_SEQ, RG_WIDTH))]


def rglru_f64(torch, a, b):
    """h and h_last of h_t = a_t h_{t-1} + b_t in float64, step by step, for
    decays a and inputs b (B,S,W): the carry cases' reference, on no path of
    the port."""
    a, b = a.double(), b.double()
    h, acc = torch.empty_like(b), torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        acc = a[:, t] * acc + b[:, t]
        h[:, t] = acc
    return h, acc


def carry_share(torch, out, exp, scale):
    """Max abs error of ``out`` against the float64 ``exp`` and its largest
    share of 2e-5 + 2e-5 (|exp| + scale); raises on a non-finite ``out``."""
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("rglru_scan output is not finite")
    err = (out.double() - exp).abs()
    return float(err.max()), float((err / (2e-5 + 2e-5 * (exp.abs() + scale))).max())


def kernels_rglru(kp: KernelPhase) -> None:
    """rglru_scan at recurrentgemma-9b's prefill and training shapes, a
    small one, ragged, phase 7's calibration shape; with a carried state
    (``RG_CARRY_SHAPES``) against float64, and twice on the same inputs for
    the same bits; rglru_scan_bwd at the training shape, S off its 16-step
    groups, W off its 128-channel blocks, with and without h_last's
    cotangent and without h's."""
    from repro_torch import kernels
    from repro_torch.calibrate import microbench as mb
    from repro_torch.kernels import ref
    torch, card, rec, cases_out, rand, launched, _ = kp.unpack()
    mod = kernels.rglru_scan

    # inputs as tests/test_kernels.py draws them: a_log = -0.5 |N(0, 1)|, b ~ N(0, 1);
    # the last is phase 7's calibration, kernel_rates' shape
    for name, (B, S, W) in [("main path", (BATCH, RG_PROMPT, RG_WIDTH)),
                            ("train path", (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH)),
                            ("S 256 W 512", (2, 256, 512)), ("ragged", (3, 77, 96)),
                            ("calibration rate", mb.RGLRU_SHAPE)]:
        a = -rand((B, S, W), torch.float32).abs() * 0.5
        b = rand((B, S, W), torch.float32)
        hh, hl = launched(mod, lambda: mod.rglru_scan(a, b))
        he, hle = ref.rglru_scan_ref(a, b)
        err, share = check(torch, hh, he, "float32")
        err_l, share_l = check(torch, hl, hle, "float32")
        cases_out.append(dict(kernel="rglru_scan", case=name, dtype="float32",
                              max_abs_err=max(err, err_l), bound_share=max(share, share_l),
                              tol=TOL["float32"]))
        log(card, f"rglru_scan {name}: B={B} S={S} W={W} float32: h max abs err {err:.3e}, "
                  f"worst element at {share:.3f} of its bound, h_last {err_l:.3e} / "
                  f"{share_l:.3f} ({TOL['float32']})")
        if name in ("main path", "train path"):
            nbytes = 4 * (3 * B * S * W + B * W)
            # the TPU kernel's work per element: exp, ceil(log2 bt) doubling rounds of
            # 3 operations, and the carried state's 2
            ops_n = float(B * S * W * (3 * math.ceil(math.log2(min(256, S))) + 3))
            bound_ms, bound_by = bound(ops_n, nbytes, "float32")
            ms = cuda_ms(torch, lambda: mod.rglru_scan(a, b), reps=20, warmup=3)
            plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_ref(a, b), reps=3)
            rec["rglru_scan" if name == "main path" else "rglru_scan_train"] = dict(
                shape=dict(B=B, S=S, W=W, dtype="float32"), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by, ops=ops_n,
                bytes=nbytes, max_abs_err=max(err, err_l), bound_share=max(share, share_l),
                tol=TOL["float32"])
        del a, b, hh, hl, he, hle
    for key, what in (("rglru_scan", "the main path's shape"),
                      ("rglru_scan_train", "the training path's shape")):
        r = rec[key]
        log(card, f"rglru_scan at {what}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                  f"no single PyTorch call computes it, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB), the kernel at "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")

    for (dname, scale), (name, (B, S, W)) in itertools.product(RG_CARRY_DECAYS, RG_CARRY_SHAPES):
        a = -rand((B, S, W), torch.float32).abs() * scale
        b = rand((B, S, W), torch.float32)
        hh, hl = launched(mod, lambda: mod.rglru_scan(a, b))
        he, hle = ref.rglru_scan_ref(a, b)
        decays = {"float32": torch.exp(a), "exact": torch.exp(a.double())}
        shares = {}
        for kind, a_t in decays.items():
            h64, hl64 = rglru_f64(torch, a_t, b)
            rms = h64.pow(2).mean(dim=1).sqrt()
            for who, h_, l_ in (("kernel", hh, hl), ("plain", he, hle)):
                both = [carry_share(torch, x, e, sc) for x, e, sc in
                        ((h_, h64, rms[:, None]), (l_, hl64, rms))]
                shares[who, kind] = max(e for e, _ in both), max(x for _, x in both)
            del h64, hl64
        (err, share), (perr, pshare) = shares["kernel", "float32"], shares["plain", "float32"]
        exact = {who: shares[who, "exact"][1] for who in ("kernel", "plain")}
        cases_out.append(dict(kernel="rglru_scan", case=f"{dname} {name}", dtype="float32",
                              max_abs_err=err, bound_share=share, plain_max_abs_err=perr,
                              plain_bound_share=pshare, exact_decay_share=exact,
                              tol=RG_CARRY_TOL))
        log(card, f"rglru_scan {dname} {name}: B={B} S={S} W={W} float32 against float64: "
                  f"kernel max abs err {err:.3e} at {share:.3f} of its bound, plain {perr:.3e} "
                  f"at {pshare:.3f} ({RG_CARRY_TOL}); on the exact decays kernel "
                  f"{exact['kernel']:.3f}, plain {exact['plain']:.3f}")
        if max(share, pshare) > 1.0:
            raise AssertionError(f"rglru_scan {dname} {name}: kernel {share:.3g}, plain "
                                 f"{pshare:.3g} x the bound ({RG_CARRY_TOL})")
        if dname == "near-one decay" and name == "train path":
            rel = (decays["float32"].double() / decays["exact"] - 1) / 2.0 ** -24
            log(card, f"rglru_scan {dname} {name}: the card's float32 exp of these a_log is off "
                      f"the exact decay by {float(rel.mean()):+.4f} ulp on average (ulp 2^-24, "
                      f"rms {float(rel.pow(2).mean().sqrt()):.4f})")
            del rel
            h2, hl2 = launched(mod, lambda: mod.rglru_scan(a, b))
            same = torch.equal(hh, h2) and torch.equal(hl, hl2)
            last = torch.equal(hl, hh[:, -1])
            log(card, f"rglru_scan {dname} {name}: two launches bitwise equal {same}, h_last "
                      f"equal to h's last step {last}")
            if not (same and last):
                raise AssertionError("rglru_scan is not bit-reproducible, or h_last is not "
                                     "h's last step")
            del h2, hl2
        del a, b, hh, hl, he, hle, decays
    torch.cuda.empty_cache()

    # the backward on the forward kernel's h, against its plain version (float32)
    for name, (B, S, W), with_dh, with_last in [
            ("train path", (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH), True, False),
            ("train path with dh_last", (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_WIDTH), True, True),
            ("S 300 off the step group", (2, 300, 512), True, True),
            ("W 200 off the channel block", (3, 256, 200), True, False),
            ("dh_last alone", (2, 77, 256), False, True)]:
        a = -rand((B, S, W), torch.float32).abs() * 0.5
        h = mod.rglru_scan(a, rand((B, S, W), torch.float32))[0]
        dh = rand((B, S, W), torch.float32) if with_dh else None
        dl = rand((B, W), torch.float32) if with_last else None
        got = launched(mod, lambda: mod.rglru_scan_bwd(a, h, dh, dl), "bwd_launches")
        exp = ref.rglru_scan_bwd_ref(a, h, dh, dl)
        errs = {n: check(torch, g, e, "float32") for n, g, e in zip(("da_log", "db"), got, exp)}
        err, share = max(e for e, _ in errs.values()), max(sh for _, sh in errs.values())
        cases_out.append(dict(kernel="rglru_scan_bwd", case=name, dtype="float32",
                              max_abs_err=err, bound_share=share, tol=TOL["float32"]))
        log(card, f"rglru_scan_bwd {name}: B={B} S={S} W={W} float32, dh {with_dh}, dh_last "
                  f"{with_last}: " + ", ".join(f"{n} max abs err {e:.3e} at {sh:.3f} of its "
                                               f"bound" for n, (e, sh) in errs.items())
                  + f" ({TOL['float32']})")
        if name == "train path":
            # reads a_log, h, dh; writes da_log, db; a few operations an element
            nbytes = 4 * 5 * B * S * W
            bound_ms, bound_by = bound(6.0 * B * S * W, nbytes, "float32")
            ms = cuda_ms(torch, lambda: mod.rglru_scan_bwd(a, h, dh, dl), reps=20, warmup=3)
            plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_bwd_ref(a, h, dh, dl), reps=3)
            rec["rglru_scan_bwd"] = dict(
                shape=dict(B=B, S=S, W=W, dtype="float32", dh_last=with_last), ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                ops=6.0 * B * S * W, bytes=nbytes, max_abs_err=err, bound_share=share,
                tol=TOL["float32"])
        del a, h, dh, dl, got, exp
    r = rec["rglru_scan_bwd"]
    log(card, f"rglru_scan_bwd at the training path's shape: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, no single PyTorch call computes it, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()


BWD_STAGES = ("flash_bwd_dsum_kernel", "flash_bwd_wgmma_kernel", "flash_bwd_convert_kernel")
# (name, (B, S, H, KV, d), window, dtype); the first is the training path's shape
BWD_CASES = [
    ("train path", (TRAIN_BATCH, TRAIN_SEQ, HEADS, KV_HEADS, HEAD_DIM), None, "bfloat16"),
    ("d64", (1, 2048, 16, 2, 64), None, "bfloat16"),
    ("G=1", (1, 2048, 16, 16, HEAD_DIM), None, "bfloat16"),
    ("window 2048", (1, TRAIN_SEQ, HEADS, KV_HEADS, HEAD_DIM), 2048, "bfloat16"),
    ("ragged S", (2, 1000, 16, 2, HEAD_DIM), None, "bfloat16"),
    ("ragged window d64 MQA", (1, 333, 8, 1, 64), 100, "bfloat16"),
    ("f32", (1, 1024, HEADS, KV_HEADS, HEAD_DIM), None, "float32"),
    ("f32 ragged window d64", (2, 300, 8, 2, 64), 40, "float32"),
    # h2o-danube-1.8b's training shape: head_dim 80, S = 8192 above its 4096 window
    ("d80 train path", (H2O_TRAIN_BATCH, H2O_TRAIN_SEQ, H2O_HEADS, H2O_KV, H2O_HEAD_DIM),
     H2O_WINDOW, "bfloat16"),
    ("f32 ragged window d80", (2, 300, 8, 2, H2O_HEAD_DIM), 100, "float32"),
    # granite-20b's group: 48 query heads on one KV head (its plan splits the group)
    ("G=48", (1, TRAIN_SEQ, G48_HEADS, 1, HEAD_DIM), None, "bfloat16"),
    ("G=48 split S=1024", (1, 1024, G48_HEADS, 1, HEAD_DIM), None, "bfloat16"),
    ("G=48 split window 300", (1, 1024, G48_HEADS, 1, HEAD_DIM), 300, "bfloat16"),
    # one key tile, ragged: every block of the plan is one query head
    ("one block", (1, 100, 8, 1, HEAD_DIM), None, "bfloat16"),
    # phase 6's h2o-danube-1.8b microbatch, in bf16 and in float32 (the CUDA-core kernels)
    ("d80 plan", (H2O_MB, PLAN_SEQ, H2O_HEADS, H2O_KV, H2O_HEAD_DIM), H2O_WINDOW, "bfloat16"),
    ("f32 d80 plan", (H2O_MB, PLAN_SEQ, H2O_HEADS, H2O_KV, H2O_HEAD_DIM), H2O_WINDOW,
     "float32"),
    # recurrentgemma-9b's training shape: head_dim 256 (its own 64-key instance), 16
    # heads on one KV head, the 2048 window at S = 4096 (the plan splits the group in
    # two); ragged S; a small window; one key tile, its group split over every head
    ("d256 train path", (RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_HEADS, 1, RG_HEAD_DIM), RG_PROMPT,
     "bfloat16"),
    ("d256 ragged S", (2, 333, RG_HEADS, 1, RG_HEAD_DIM), None, "bfloat16"),
    ("d256 window 40", (1, 1000, RG_HEADS, 1, RG_HEAD_DIM), 40, "bfloat16"),
    ("d256 split one tile", (1, 64, RG_HEADS, 1, RG_HEAD_DIM), None, "bfloat16"),
    # olmoe-1b-7b's training shape: 16 query heads on 16 KV heads (G = 1), d = 128
    ("G=1 train path", (OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, OLMOE_HEADS, OLMOE_HEADS, HEAD_DIM),
     None, "bfloat16")]
# the cases timed against their bound and the library, by record key
BWD_MAINS = {"train path": "flash_attention_bwd", "d80 train path": "flash_attention_bwd_d80",
             "G=48": "flash_attention_bwd_g48", "d256 train path": "flash_attention_bwd_d256",
             "G=1 train path": "flash_attention_bwd_g1"}


def flash_bwd_plain(torch, ref, q, k, v, out, lse, dout, window):
    """flash_attention_bwd_ref a (batch row, KV head) at a time: all rows'
    (S, T) f32 scores, probabilities and their gradients do not fit."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=DEVICE) for t in (q, k, v))
    for b in range(B):
        for j in range(KV):
            hs = slice(j * G, (j + 1) * G)
            g = ref.flash_attention_bwd_ref(
                q[b:b + 1, :, hs].float(), k[b:b + 1, :, j:j + 1].float(),
                v[b:b + 1, :, j:j + 1].float(), out[b:b + 1, :, hs].float(), lse[b:b + 1, hs],
                dout[b:b + 1, :, hs].float(), causal=True, window=window)
            dq[b:b + 1, :, hs], dk[b:b + 1, :, j:j + 1], dv[b:b + 1, :, j:j + 1] = g
    return dq, dk, dv


def kernels_flash_bwd(kp: KernelPhase) -> None:
    """flash_attention_bwd at qwen3-32b's, h2o-danube-1.8b's,
    recurrentgemma-9b's and olmoe-1b-7b's training shapes, head_dim 64, 80 and 256, G = 1, 8,
    16 and 48, windows at S = 4096 and 8192, ragged S, float32,
    h2o-danube-1.8b's pipeline microbatch in bf16 and float32, a group split
    over every head at head_dim 256; each against its plain version on the same
    inputs (the forward kernel's output and log-sum-exp, which is itself
    held against the plain log-sum-exp)."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    torch, card, rec, cases_out, rand, launched, dtypes = kp.unpack()
    mod = kernels.flash_attention
    for name, (B, S, h, kv, d), window, dt in BWD_CASES:
        q, k, v = rand((B, S, h, d), dtypes[dt]), rand((B, S, kv, d), dtypes[dt]), \
            rand((B, S, kv, d), dtypes[dt])
        dout = rand((B, S, h, d), dtypes[dt])
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        lse_plain = torch.cat([ref.flash_attention_lse_ref(q[i:i + 1].float(), k[i:i + 1].float(),
                                                           causal=True, window=window)
                               for i in range(B)])
        err_l, share_l = check(torch, lse, lse_plain, "float32")
        got = launched(mod, lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                                            window=window), "bwd_launches")
        exp = flash_bwd_plain(torch, ref, q, k, v, out, lse, dout, window)
        tol = TOL["bfloat16 grad" if dt == "bfloat16" else dt]
        errs = {n: check(torch, g, e, dt, BWD_FLOOR) for n, g, e in zip(("dq", "dk", "dv"), got, exp)}
        err, share = max(e for e, _ in errs.values()), max(sh for _, sh in errs.values())
        cases_out.append(dict(kernel="flash_attention_bwd", case=name, dtype=dt, max_abs_err=err,
                              bound_share=share, tol=tol,
                              by_output={n: dict(max_abs_err=e, bound_share=sh)
                                         for n, (e, sh) in errs.items()},
                              lse_max_abs_err=err_l, lse_bound_share=share_l))
        log(card, f"flash_attention_bwd {name}: B={B} S={S} H={h} KV={kv} d={d} {dt} window="
                  f"{window}: " + ", ".join(f"{n} max abs err {e:.3e} at {sh:.3f} of its bound"
                                            for n, (e, sh) in errs.items())
                  + f" ({tol}); the forward's lse {err_l:.3e}, {share_l:.3f} of "
                    f"{TOL['float32']}")
        if name in BWD_MAINS:
            n_split = mod.bwd_split_plan(B, S, kv, h // kv, d)
            blocks = -(-S // mod.bwd_key_tile(d)) * kv * B * n_split
            log(card, f"flash_attention_bwd {name}: split plan {n_split} (query heads of a "
                      f"group per block {h // kv // n_split}), {blocks} blocks of the wgmma kernel")
            live = live_pairs(S, S, True, window)
            # the least work: the S recompute, dP, dV, dK and dQ, 2 d each per live pair
            ops_n = 10.0 * B * h * d * live
            elt = 2
            nbytes = elt * (4 * B * S * h * d + 4 * B * S * kv * d) + 4 * B * h * S
            bound_ms, bound_by = bound(ops_n, nbytes, dt)
            if window is None or window >= S:     # causal GQA: the flash backend
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                              for x in (q, k, v))
                o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True)
            else:
                # a window needs a mask, which the flash backend and GQA (flash and math
                # only) do not take together: K and V repeated to every query head
                # beforehand and a boolean mask, for the memory-efficient backend
                qt = q.transpose(1, 2).detach().requires_grad_(True)
                kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1).detach()
                          .requires_grad_(True) for x in (k, v))
                pos = torch.arange(S, device=DEVICE)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            do_t = dout.transpose(1, 2)

            def library():
                return torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True)
            ms, lib_ms, readings = paired_ms(
                torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                                       window=window),
                library, reps=3, rounds=3, warmup=1)
            plain_ms = cuda_ms(torch, lambda: flash_bwd_plain(torch, ref, q, k, v, out, lse, dout,
                                                              window), reps=1)
            def three():
                for _ in range(3):
                    ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
            stages = {k_: 0.0 for k_ in BWD_STAGES}
            for e in device_window(torch, card, three, cpu=False)[0]:
                for k_ in BWD_STAGES:
                    if f"{k_}<" in e.key or f"{k_}(" in e.key:
                        stages[k_] += e.self_device_time_total / 1e3 / 3
            if not all(t > 0 for t in stages.values()):
                raise AssertionError(f"the profiler saw no device time for a stage: {stages}")
            rec[BWD_MAINS[name]] = dict(
                shape=dict(B=B, S=S, T=S, H=h, KV=kv, d=d, dtype=dt, causal=True, window=window),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops_n, bytes=nbytes, max_abs_err=err, bound_share=share,
                tol=tol, timing=readings, stages_ms=stages, n_split=n_split, blocks=blocks)
            for k_ in BWD_STAGES:
                log(card, f"flash_attention_bwd {name} stage {k_}: {stages[k_]:.4f} ms on the "
                          f"device (profiler, mean of 3 calls)")
            del qt, kt, vt, o_lib, do_t
        del q, k, v, dout, out, lse, lse_plain, got, exp
        torch.cuda.empty_cache()
    for name, key in BWD_MAINS.items():
        r = rec[key]
        log(card, f"flash_attention_bwd at the {name} shape: kernels {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention's backward "
                  f"{r['library_ms']:.3f} ms (medians of turns), bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']}: {r['ops'] / 1e12:.3f} TFLOP, {r['bytes'] / 1e9:.3f} GB)")
    torch.cuda.empty_cache()


def phase_kernels(torch, card: str) -> dict:
    kp = KernelPhase(torch, card)
    for run in (kernels_flash, kernels_flash_bwd, kernels_decode, kernels_decode_partial,
                kernels_ssd, kernels_ssd_bwd, kernels_rglru):
        run(kp)
    kp.rec["cases"] = kp.cases
    return kp.rec


def device_window(torch, card: str, fn, cpu: bool):
    """``key_averages()`` of a torch.profiler window (CUDA activity, and the
    CPU's with ``cpu``) around one ``fn()`` call, and the call's wall ms.
    CUPTI has handed back a window with no device event at all on the H100
    (once, over three flash backward calls that other runs profiled
    fine); such a window is taken once more, and a second empty one is
    returned as it is, for the caller's check to fail on."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for attempt in range(2):
        torch.cuda.synchronize()
        with tprofile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = prof.key_averages()
        if any(e.self_device_time_total > 0 for e in rows):
            break
        log(card, f"the profiler window saw no device time (try {attempt + 1} of 2)")
    return rows, wall_ms


def profile(torch, fn, card: str, what: str, groups: Optional[dict] = None) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from torch.profiler (CUPTI); with ``groups`` ({label: kernel
    name prefix, or a tuple of them}) also each group's device time and
    share of the busy time."""
    rows, wall_ms = device_window(torch, card, fn, cpu=True)
    dev = [e for e in rows
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    rows = [dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count)
            for e in top]
    log(card, f"profile of {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in dev)} kernel launches")
    for row in rows:
        log(card, f"  {row['ms']:9.3f} ms {row['calls']:5d}x  {row['kernel']}")
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, top=rows)
    for label, prefix in (groups or {}).items():
        ms = sum(e.self_device_time_total for e in dev if _kernel_key(e.key).startswith(prefix))
        out[label] = dict(ms=ms / 1e3, share=ms / 1e3 / busy_ms)
        log(card, f"  {label}: {ms / 1e3:.3f} ms of device time, {100 * ms / 1e3 / busy_ms:.2f}% "
                  f"of the busy time")
    return out


def _kernel_key(name: str) -> str:
    """``flash_bwd_wgmma_kernel<128, 128>(...)`` from a profiler row's demangled name."""
    name = re.sub(r"^void ", "", name)
    return re.sub(r"^\(anonymous namespace\)::", "", name)


@dataclasses.dataclass(frozen=True)
class ServePath:
    """One serving path: the arch, its depth (None: full), its prompt, the
    kernel launches one prefill and one decode step must make, and the
    decode-vs-fresh-prefill check at batch 1 (prefill ``check_prefix``
    tokens, decode ``check_steps`` more, against one prefill of them all,
    with the weights in ``check_dtype`` and the first ``check_layers``
    layers)."""
    arch: str
    layers: Optional[int]
    prompt: int
    prefill_launches: Dict[str, int]
    step_launches: Dict[str, int]
    check_prefix: int
    check_steps: int
    check_dtype: str
    check_layers: Optional[int]    # None: the path's depth
    warm_len: int          # a warm-up prefill at batch 1 that reaches the path's kernels
    qk_fan_in: bool = False   # wq and wk at the fan-in of d_model (see fan_in_qk)
    # MoE: the check runs at the lossless capacity factor n_experts /
    # experts_per_token. At the served 1.25 a fresh prefill drops tokens by
    # their rank in token order, so it and the step-by-step decode would
    # route differently by design
    check_lossless: bool = False


PATHS = [
    # decode step vs a fresh prefill over prompt + token: the decode kernel
    # produces the one, the flash kernel (S = 4097) the other
    ServePath("qwen3_32b", LAYERS, PROMPT, {"flash_attention": LAYERS},
              {"decode_attention": LAYERS}, PROMPT, 1, "bfloat16", None, PROMPT + 1),
    # 48 SSD layers; both check prefills (512 and 768) are multiples of the
    # 256-step chunk, so both reach the ssd_scan kernel. The check runs the
    # same seed's weights in float32: in bf16 the decode step and the chunked
    # prefill round at different points (the JAX package's cast points:
    # prefill rounds dt and x*dt to bf16, decode keeps them in f32), and over
    # 48 layers of random weights the two drift apart by more than 3e-2 with
    # no error in either (the bf16 figure is printed beside the check)
    ServePath("mamba2_780m", None, PROMPT, {"ssd_scan": 48}, {}, 512, 256, "float32", None,
              256),
    # 26 rec + 12 local_attn layers; prefill at the 2048 window (plain GQA
    # attention up to attn_chunk), the checks' 1792 and 2048 reach rglru_scan.
    # float32 for the same reason, and at 8 layers (two stacked units and the
    # two-layer tail, so every cache layout is checked): with random weights
    # the 38-layer model is chaotic, a 1e-7 change of the embedding already
    # moves its logits by O(1) (printed beside the check)
    ServePath("recurrentgemma_9b", None, RG_PROMPT, {"rglru_scan": 26},
              {"decode_attention": 12}, RG_PROMPT - 256, 256, "float32", 8, 256),
    # all 24 layers, head_dim 80, window 4096: the decode ring holds
    # min(max_len, window) = 4096 slots, as the JAX package sizes it, so it
    # wraps from the first decode step; the check's fresh prefill of 4097
    # tokens drops key 0 for its last query, where the window binds. wq and
    # wk at the fan-in of d_model (the reference init's figure is printed
    # beside the check)
    ServePath("h2o_danube_1_8b", None, PROMPT, {"flash_attention": 24},
              {"decode_attention": 24}, PROMPT, 1, "bfloat16", None, PROMPT + 1, True),
    # all 16 layers of 64 experts top-8 at the reference's capacity factor 1.25
    # (the prefill routes 32 groups of 512 tokens, C = 81); 16 query heads on 16
    # KV heads of 128. The check runs at lossless capacity in float32: in bf16
    # the router's product is rounded to bf16 before its softmax, and the fresh
    # prefill's and the decode step's products round a near-tie differently,
    # which moves a token to another expert with no error in either (the bf16
    # figure is printed beside the check). Prefill 4096 tokens, then 16 steps
    ServePath("olmoe_1b_7b", None, PROMPT, {"flash_attention": 16},
              {"decode_attention": 16}, PROMPT, 16, "float32", None, PROMPT + 1,
              check_lossless=True),
    # full width, depth cut 60 -> 4: the dense-first layer and 3 MoE layers of
    # 160 experts top-6 plus 2 shared; MLA, so no kernel launches at all; the
    # 4096-token prefill above attn_chunk takes MLA's query-chunked path. The
    # check: lossless, float32 (the reason above), prefill 512 tokens (at
    # lossless capacity every expert holds a row for every token: 160 x 4.1k
    # rows of 5120 at a 4096-token prefill, too many beside the 53 GB of float32
    # weights), then 16 steps
    ServePath("deepseek_v2_236b", 4, PROMPT, {}, {}, 512, 16, "float32", None, PROMPT,
              check_lossless=True),
    # all 12 encoder and 12 decoder layers over 1500 frames (the conv frontend is a
    # stub: seeded N(0, 0.02^2) frames in bf16); the encoder and the cross-attention are
    # plain attention, the 224-token prompt stays below attn_chunk, so prefill launches
    # nothing and each decode step one decode kernel a decoder layer (d = 64, G = 1).
    # No qk-norm: wq and wk at the fan-in of d_model (the reference init's figure is
    # printed beside the check)
    ServePath("whisper_small", None, WH_PROMPT, {}, {"decode_attention": 12}, WH_PROMPT, 16,
              "bfloat16", None, 64, True),
    # all 18 layers, 256 patch embeddings (the SigLIP stub, seeded as whisper's frames)
    # before the prompt, attending bidirectionally; a prefix keeps attention off flash
    # (the reference's query-chunked path), so prefill launches nothing; decode one
    # kernel a layer at d = 256, G = 8. No qk-norm: wq and wk at the fan-in of d_model
    ServePath("paligemma_3b", None, PG_PROMPT, {}, {"decode_attention": 18}, PG_PROMPT, 16,
              "bfloat16", None, 64, True),
]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _slice(tree, n: int):
    """The first ``n`` entries of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _slice(v, n) for k, v in tree.items()}
    return tree[:n]


def decode_vs_prefill(torch, model, params, prefix, extra, stubs=None) -> dict:
    """Prefill ``prefix`` (1, p0) after the model's frontend ``stubs`` (batch
    1: whisper's frames, paligemma's patches, which also go before it in the
    cache), then decode the argmax token and ``extra`` one step at a time,
    against one prefill over all of them: the last position's logits, as
    relative L2 and max abs error and both argmaxes."""
    stubs = stubs or {}
    p0, n = prefix.shape[1] + prefix_slots(model.cfg), extra.shape[1] + 1
    with torch.no_grad():
        c1 = model.init_cache(1, p0 + n + 1)
        logits_p, c1 = model.prefill(params, prefix, c1, **stubs)
        fed = torch.cat([torch.argmax(logits_p, dim=-1).to(torch.int32), extra], dim=1)
        for i in range(n):
            logits_d, c1 = model.decode(params, fed[:, i:i + 1], c1,
                                        torch.full((1,), p0 + i, dtype=torch.int32,
                                                   device=prefix.device))
        del c1
        c2 = model.init_cache(1, p0 + n + 1)
        logits_f, _ = model.prefill(params, torch.cat([prefix, fed], dim=1), c2, **stubs)
        del c2
    v = model.cfg.vocab_size
    a, b = logits_d[0, -1, :v].float(), logits_f[0, -1, :v].float()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError("logits are not finite")
    return dict(rel_l2=float((a - b).norm() / b.norm()), max_abs_err=float((a - b).abs().max()),
                argmax=[int(a.argmax()), int(b.argmax())])


def decode_weight_bytes(cfg, params) -> int:
    """The parameter bytes one decode step must read: every leaf but the
    embedding table, which decode only indexes (unless the head reuses it),
    and the encoder's (``enc``, ``enc_pos``, ``ln_enc``: only prefill runs
    it; decode reads its output from the cross cache). An MoE layer's decode
    sends its few tokens through all of its experts' weights, as the JAX
    package computes it, so they all count."""
    skip = {"enc", "enc_pos", "ln_enc"} | ({"embed"} if not cfg.tie_embeddings else set())
    return sum(t.numel() * t.element_size() for name, sub in params.items()
               if name not in skip for t in _leaves(sub))


def prefix_slots(cfg) -> int:
    """The cache slots the VLM's patches take before the prompt (0 for other
    models); decode positions start after them."""
    return cfg.n_patches if cfg.vision_stub else 0


def stubs_for(torch, cfg, batch: int) -> dict:
    """The model's frontend stubs for a serving or training path (whisper's
    frames, paligemma's patches; {} for the others), N(0, 0.02^2) from seed 3
    in the model's dtype: the same numbers in either dtype."""
    from repro_torch.launch.steps import frontend_stubs
    return frontend_stubs(cfg, batch, DEVICE, torch.Generator(device=DEVICE).manual_seed(3))


class RoutingDrops:
    """Counts the routed (token, slot)s that MoE layers drop while active:
    ``repro_torch.models.mlp.route`` wrapped to add each call's dropped and
    total slots, on the device (read once, after the run)."""

    def __init__(self):
        self.dropped, self.slots = [], []

    def __enter__(self):
        from repro_torch.models import mlp
        self._route = route = mlp.route

        def counted(p, xg, cfg):
            r = route(p, xg, cfg)
            self.dropped.append((r.dest == cfg.n_experts * r.capacity).sum())
            self.slots.append(r.dest.numel())
            return r
        mlp.route = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mlp
        mlp.route = self._route

    def share(self) -> float:
        return float(sum(int(d) for d in self.dropped)) / sum(self.slots)


def drop_share(torch, model, params, batch) -> float:
    """The share of routed (token, slot)s that one untimed forward of
    ``model.loss`` on ``batch`` drops: the counter stays out of timed steps."""
    with RoutingDrops() as drops, torch.no_grad():
        model.loss(params, batch, remat="full")
    return drops.share()


# decode steps against a fresh prefill of the same tokens: the last logits'
# relative L2 error (bf16 decode and prefill round at different points)
DECODE_PREFILL_TOL = 3e-2


def phase_serve(torch, card: str, path: ServePath) -> dict:
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.mlp import dispatch_groups, moe_capacity

    full = get_config(path.arch)
    cfg = dataclasses.replace(full, n_layers=path.layers or full.n_layers)
    prompt = path.prompt
    model, prefill_step = make_prefill_step(cfg, device=DEVICE)
    _, serve_step = make_serve_step(cfg, device=DEVICE)
    params_ref = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    params = fan_in_qk(cfg, params_ref, path.qk_fan_in)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    analytic = cfg.param_count()     # the JAX package's formula (PERF.md: wrong for rec layers)
    log(card, f"serving {cfg.name} at full width ({cfg.family}: d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, d_ff "
              f"{cfg.d_ff}, ssm heads {cfg.ssm_nheads if cfg.ssm else 0} x state "
              f"{cfg.ssm_state}, lru width {cfg.lru_dim if cfg.block_pattern else 0}, window "
              f"{cfg.window}, experts {cfg.n_experts} top-{cfg.experts_per_token} of d_ff "
              f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared, {cfg.n_dense_layers} dense "
              f"first, MLA {cfg.mla} (q rank {cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank}), "
              f"encoder {cfg.n_enc_layers if cfg.encdec else 0} layers over "
              f"{cfg.enc_seq if cfg.encdec else 0} frames, {prefix_slots(cfg)} patches, "
              f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
              f"{cfg.dtype}), {cfg.n_layers} of {full.n_layers} layers: {n_params / 1e9:.3f} B "
              f"parameters summed from the tensors ({n_bytes / 1e9:.2f} GB), "
              f"ArchConfig.param_count() {analytic / 1e9:.3f} B")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, prompt)),
                             dtype=torch.int32, device=DEVICE)
    # the frontend stubs (frames, patches); the patches take cache slots before
    # the prompt, and decode positions start after them
    stubs = stubs_for(torch, cfg, BATCH)
    first = {k: t[:1] for k, t in stubs.items()}
    off = prefix_slots(cfg)
    cache = model.init_cache(BATCH, off + prompt + GEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # warm-up on a separate cache so the timed run excludes first-call costs
    warm = model.init_cache(1, off + path.warm_len + 8)
    tok_w, warm = prefill_step(params, tokens[:1, :path.warm_len], warm, first)
    serve_step(params, tok_w, warm, torch.full((1,), off + path.warm_len, dtype=torch.int32,
                                               device=DEVICE))
    del warm
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    tok, cache = prefill_step(params, tokens, cache, stubs)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = kernels.launch_counts()
    generated, lat = [tok], []
    for i in range(GEN):
        pos = torch.full((BATCH,), off + prompt + i, dtype=torch.int32, device=DEVICE)
        t1 = time.perf_counter()
        tok, cache = serve_step(params, tok, cache, pos)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
        generated.append(tok)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want_prefill = {k: path.prefill_launches.get(k, 0) for k in kernels.KERNELS}
    want = {k: want_prefill[k] + GEN * path.step_launches.get(k, 0) for k in kernels.KERNELS}
    if after_prefill != want_prefill:
        raise AssertionError(f"prefill launches {after_prefill}, expected {want_prefill}")
    if counts != want:
        raise AssertionError(f"serving launches {counts}, expected {want}")
    gen_toks = torch.cat(generated, dim=1).cpu()
    if gen_toks.shape != (BATCH, GEN + 1) or gen_toks.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(gen_toks.shape)} {gen_toks.dtype}")
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")

    # where the time goes: one prefill and three decode steps under the profiler
    # (the decode steps rewrite the cache's last slot; the counts are already read)
    last = torch.full((BATCH,), off + prompt + GEN - 1, dtype=torch.int32, device=DEVICE)
    with RoutingDrops() as drops:     # the routed slots the prefill's MoE layers drop
        prof = {"prefill": profile(torch, lambda: prefill_step(params, tokens, cache, stubs),
                                   card,
                                   f"one {cfg.name} prefill ({BATCH}x{prompt})")}
    prof["decode"] = profile(torch, lambda: [serve_step(params, tok, cache, last)
                                             for _ in range(3)], card,
                             f"three {cfg.name} decode steps")
    del cache
    moe = None
    if cfg.n_experts:
        T = BATCH * prompt
        G = dispatch_groups(T, cfg)
        C = moe_capacity(cfg, T // G)
        moe = dict(groups=G, capacity=C, rows=G * cfg.n_experts * C,
                   routed_slots=T * cfg.experts_per_token, dropped_share=drops.share(),
                   capacity_factor=cfg.capacity_factor)
        log(card, f"{cfg.name} prefill routing: {G} dispatch groups of {T // G} tokens, "
                  f"capacity {C} (factor {cfg.capacity_factor}), expert products on "
                  f"{moe['rows']} rows for {moe['routed_slots']} routed slots; the profiled "
                  f"prefill's MoE layers dropped {100 * moe['dropped_share']:.3f}% of their "
                  f"routed slots")
    elif drops.slots:
        raise AssertionError(f"{cfg.name} has no experts but routed {len(drops.slots)} times")

    lat_a = np.array(lat)
    p50, p99 = float(np.percentile(lat_a, 50)), float(np.percentile(lat_a, 99))
    tok_s = BATCH * GEN / (lat_a.sum() / 1e3)
    step_bytes = decode_weight_bytes(cfg, params)
    floor_ms = step_bytes / HBM_BYTES_S * 1e3
    log(card, f"{cfg.name} prefill {BATCH}x{prompt} tokens: {prefill_ms:.1f} ms "
              f"({BATCH * prompt / prefill_ms * 1e3:.0f} tokens/s)")
    log(card, f"{cfg.name} decode {GEN} steps at batch {BATCH}: p50 {p50:.2f} ms p99 "
              f"{p99:.2f} ms per token step, {tok_s:.1f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(card, f"{cfg.name} decode step's weight bytes (every leaf but the indexed embedding "
              f"table and the encoder): {step_bytes / 1e9:.3f} GB, a floor of {floor_ms:.3f} ms "
              f"at 3.35 TB/s, "
              f"beside its p50 of {p50:.2f} ms")
    log(card, f"{cfg.name} launches: prefill {after_prefill}, prefill + {GEN} decode steps "
              f"{counts}")

    # decode steps vs one fresh prefill over the same tokens, at batch 1
    p0, n = path.check_prefix, path.check_steps
    extra = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n - 1)), dtype=torch.int32,
                            device=DEVICE)
    check = {}
    if path.check_lossless:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
        model = build_model(cfg, device=DEVICE)
        log(card, f"{cfg.name} decode-vs-prefill check at the lossless capacity factor "
                  f"{cfg.capacity_factor:.4f} (n_experts / experts_per_token; served at "
                  f"{full.capacity_factor})")
        check["capacity_factor"] = cfg.capacity_factor
    served = decode_vs_prefill(torch, model, params, tokens[:1, :p0], extra, first)
    if path.qk_fan_in:      # the same check with the reference init's wq and wk
        check["reference_init"] = decode_vs_prefill(torch, model, params_ref, tokens[:1, :p0],
                                                    extra, first)
        log(card, f"{cfg.name} decode vs fresh prefill with the reference init's wq and wk "
                  f"(fan-in read from the head axis; without qk-norm the attention is a hard "
                  f"max and the random model chaotic): relative L2 "
                  f"{check['reference_init']['rel_l2']:.3e}, argmax "
                  f"{check['reference_init']['argmax']} (reported, not checked)")
    del params_ref
    if path.check_dtype == cfg.dtype:
        check.update(served)
    else:
        log(card, f"{cfg.name} decode vs fresh prefill at batch 1 in the served {cfg.dtype}: "
                  f"relative L2 {served['rel_l2']:.3e}, argmax {served['argmax']} (reported, "
                  f"not checked: decode and prefill round to {cfg.dtype} at different points)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, dtype=path.check_dtype)   # the same seed's weights
        model = build_model(cfg, device=DEVICE)
        params = fan_in_qk(cfg, model.init(torch.Generator(device=DEVICE).manual_seed(0)),
                           path.qk_fan_in)
        first = {k: t[:1] for k, t in stubs_for(torch, cfg, BATCH).items()}
        # how far a 1e-7 relative change of the embedding moves the last logits
        seq = torch.cat([tokens[:1, :p0], extra[:, :1], extra], dim=1)[:, :p0 + n]
        with torch.no_grad():
            base = model.prefill(params, seq, model.init_cache(1, off + p0 + n + 1), **first)[0]
            embed = params["embed"]
            params["embed"] = embed * (1 + 1e-7 * torch.randn(
                embed.shape, generator=torch.Generator(device=DEVICE).manual_seed(1),
                device=DEVICE))
            moved = model.prefill(params, seq, model.init_cache(1, off + p0 + n + 1),
                                  **first)[0]
            params["embed"] = embed
        v = cfg.vocab_size
        sens = float((moved[0, -1, :v] - base[0, -1, :v]).norm() / base[0, -1, :v].norm())
        del base, moved
        log(card, f"{cfg.name} in {cfg.dtype} at {cfg.n_layers} layers: a 1e-7 relative "
                  f"change of the embedding moves the last logits by relative L2 {sens:.3e}")
        check["sensitivity_full_depth"] = sens
        if path.check_layers:     # the first units and the tail, as views
            cfg = dataclasses.replace(cfg, n_layers=path.check_layers)
            model = build_model(cfg, device=DEVICE)
            _, n_units, _ = model.scan_groups()
            params = {**params, "stack": {k: _slice(t, n_units)
                                          for k, t in params["stack"].items()}}
        check.update(decode_vs_prefill(torch, model, params, tokens[:1, :p0], extra, first))
    rel = check["rel_l2"]
    consistency_tol = DECODE_PREFILL_TOL
    log(card, f"{cfg.name} decode vs fresh prefill at batch 1, {cfg.dtype} weights, "
              f"{cfg.n_layers} layers: prefill {p0} (after {off} patches), {n} decode step(s), "
              f"against one prefill of {p0 + n}: relative L2 error {rel:.3e} (tol "
              f"{consistency_tol}), max abs err "
              f"{check['max_abs_err']:.3e}, argmax {check['argmax']}")
    if rel > consistency_tol:
        raise AssertionError("decode steps disagree with a fresh prefill")
    check.update(prefix=p0, steps=n, dtype=cfg.dtype, n_layers=cfg.n_layers,
                 served_rel_l2=served["rel_l2"])
    return dict(config=full.name, n_layers=path.layers or full.n_layers,
                full_layers=full.n_layers,
                params=n_params, params_b=n_params / 1e9, param_bytes=n_bytes,
                param_count_analytic_b=analytic / 1e9, batch=BATCH, prompt=prompt,
                gen=GEN, prefix_slots=off, prefill_ms=prefill_ms, decode_p50_ms=p50,
                decode_p99_ms=p99,
                decode_tokens_s=tok_s, peak_bytes=peak, launches=counts,
                launches_prefill=after_prefill, consistency_rel_l2=rel, consistency=check,
                decode_ms=lat, decode_weight_bytes=step_bytes, decode_floor_ms=floor_ms,
                moe=moe, profile=prof)


# (arch, overrides, prefill length, decode steps, launches the card must make)
SMALL = [
    ("qwen3_32b", dict(head_dim=64, n_layers=2, attn_chunk=64), 128, 3,
     {"flash_attention": 2, "decode_attention": 6}),
    ("mamba2_780m", {}, 64, 3, {"ssd_scan": 4}),                 # chunk 32: 2 chunks
    # head_dim 64 for the decode kernel; window 32: prefill rolls the ring and
    # every decode step wraps it; prompt 300, off the TPU kernel's 256-step
    # tiles, still takes rglru_scan on every rec layer
    ("recurrentgemma_9b", dict(head_dim=64), 300, 6, {"rglru_scan": 4, "decode_attention": 6}),
    # head_dim 80; attn_chunk 64 < prompt 128, so prefill takes the flash kernel,
    # whose window 96 binds; the decode ring of 96 slots wraps on every step.
    # wq and wk at the fan-in of d_model
    ("h2o_danube_1_8b", dict(head_dim=80, n_layers=2, attn_chunk=64, window=96), 128, 6,
     {"flash_attention": 2, "decode_attention": 12}, True),
    # MoE, each also held on every cache leaf: the reduced olmoe (3 MoE layers of
    # 8 experts top-2 at the reference's capacity, so tokens are dropped) at
    # head_dim 64, attn_chunk 64 < prompt 256: the flash and decode kernels at
    # G = 1; the reduced deepseek (MLA, shared experts, the dense-first tail
    # first), attn_chunk 64 < 256: MLA's query-chunked prefill, no kernel
    ("olmoe_1b_7b", dict(head_dim=64, attn_chunk=64), 256, 4,
     {"flash_attention": 3, "decode_attention": 12}, False, True),
    ("deepseek_v2_236b", dict(attn_chunk=64), 256, 4, {}, False, True),
]
# (arch, overrides, S, wq and wk at the fan-in of d_model) of the small float32
# train steps, card against CPU: attn_chunk 64 < S, so the flash forward and
# backward kernels run; the reduced mamba2 (4 layers, chunk 32) at S = 128 runs
# the SSD scan's forward and backward kernels, the reduced recurrentgemma the
# RG-LRU scan's
SMALL_TRAIN = [
    ("qwen3_32b", dict(head_dim=64, attn_chunk=64), 256, False),
    # the reduced recurrentgemma (a (rec, rec, local_attn) unit and two rec tail layers),
    # head_dim 64: its window of 32 binds in the flash kernels, and the RG-LRU scan's
    # forward and backward kernels run (6 + 4 a step; flash 2 + 1). wq and wk at the
    # fan-in of d_model: with the reference init's a 1e-7 change of the embedding moves
    # the CPU's gradients by 3.0e-4 of a leaf's max, above the 1e-4 tolerance (4.5e-6
    # with fan_in_qk)
    ("recurrentgemma_9b", dict(head_dim=64, attn_chunk=64), 256, True),
    # head_dim 80, and a window below S that binds in both kernels
    ("h2o_danube_1_8b", dict(head_dim=80, n_layers=2, attn_chunk=64, window=96), 256, True),
    ("mamba2_780m", {}, 128, False),
    # MoE: the reduced olmoe (3 MoE layers of 8 experts top-2 at the reference's
    # capacity, so slots drop) at head_dim 64: the flash forward and backward at
    # G = 1; the reduced deepseek (MLA's query-chunked prefill nested in the unit's
    # remat, the dense-first tail first, shared experts): no kernel. The aux loss
    # is compared too
    ("olmoe_1b_7b", dict(head_dim=64, attn_chunk=64), 256, False),
    ("deepseek_v2_236b", dict(attn_chunk=64), 256, False),
]


# the forward and backward kernel of each layer kind (an MoE model's layers
# attend as the dense ones; with MLA they take no kernel)
ATTN = ("flash_attention", "flash_attention_bwd")
KIND_KERNELS = {"dense": ATTN, "local_attn": ATTN, "moe": ATTN, "dense_mlp": ATTN,
                "ssm": ("ssd_scan", "ssd_scan_bwd"), "rec": ("rglru_scan", "rglru_scan_bwd")}


def train_launches(cfg, seq: int) -> Dict[str, int]:
    """The kernel launches of one train step with remat="full" at sequence
    ``seq``, by layer kind: a stacked unit's layer runs its kernel forward
    twice (forward and the unit's recompute) and backward once; a tail
    layer, which ``LM.apply`` does not rematerialise, forward once and
    backward once. Attention launches flash only above attn_chunk and
    without a prefix (a VLM always has one), MLA never; the encoder-decoder's
    decoder layers are each rematerialised, its encoder and cross-attention
    launch nothing."""
    from repro_torch.models import build_model
    flash = seq > cfg.attn_chunk and not cfg.prefix_len
    if cfg.encdec:
        return {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers} if flash else {}
    unit, n_units, tail = build_model(cfg, device="cpu").scan_groups()
    out: Dict[str, int] = {}
    for kinds, fwd_calls, reps in ((unit, 2, n_units), (tail, 1, 1)):
        for kind in kinds:
            if KIND_KERNELS[kind] == ATTN and (cfg.mla or not flash):
                continue
            fwd, bwd = KIND_KERNELS[kind]
            out[fwd] = out.get(fwd, 0) + fwd_calls * reps
            out[bwd] = out.get(bwd, 0) + reps
    return out


# The reference init (``dense_init``, as the JAX package's) reads the fan-in
# of the (d_model, heads, head_dim) projections from the head axis, so wq
# and wk have std heads**-0.5 and, without qk-norm, h2o's attention logits
# come out with a std of ~d_model / heads (80 at full width): the softmax is
# a hard max, the random model is chaotic and its gradients explode with
# depth (phases 3 and 5 print the reference init's figures). Its h2o paths
# here multiply the reference init's wq and wk by sqrt(heads / d_model),
# the std a fan-in of d_model gives wq; each small check prints how far a
# 1e-7 change of the embedding moves its CPU result, the floor under any
# card-vs-CPU difference.
def fan_in_qk(cfg, params, on: bool = True):
    """``params`` with every layer's wq and wk multiplied by
    sqrt(heads / d_model) (``params`` itself when ``on`` is false): the
    decoder-only stack's and tail's attention, or the encoder-decoder's
    three (the encoder's, the decoder's self- and cross-attention)."""
    if not on:
        return params
    scale = (cfg.n_heads / cfg.d_model) ** 0.5

    def scaled(attn):
        return {k: (w * scale if k in ("wq", "wk") else w) for k, w in attn.items()}
    out = dict(params)
    if cfg.encdec:
        out["enc"] = dict(params["enc"], attn=scaled(params["enc"]["attn"]))
        out["dec"] = dict(params["dec"], self_attn=scaled(params["dec"]["self_attn"]),
                          cross_attn=scaled(params["dec"]["cross_attn"]))
        return out
    for group in ("stack", "tail"):
        if group in params:
            out[group] = {u: dict(block, mixer=scaled(block["mixer"]))
                          for u, block in params[group].items()}
    return out


def _nudged(torch, params):
    """``params`` (on the CPU) with the embedding changed by 1e-7 relative:
    how far that moves a result on the CPU alone is the conditioning of a
    card-vs-CPU check of it."""
    e = params["embed"]
    noise = torch.randn(e.shape, generator=torch.Generator().manual_seed(3))
    return dict(params, embed=e * (1 + 1e-7 * noise))


def _serve_logits(torch, model, params, toks, prompt: int, steps: int, caches=None) -> list:
    """The logits of a prefill of ``prompt`` tokens and ``steps`` decode
    steps; with a list ``caches``, every cache leaf after the last step is
    appended to it (on the CPU, in tree order)."""
    dev = model.device
    out = []
    with torch.no_grad():
        cache = model.init_cache(2, prompt + steps + 5)
        logits, cache = model.prefill(params, toks[:, :prompt].to(dev), cache)
        out.append(logits.cpu())
        for i in range(steps):
            pos = torch.full((2,), prompt + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode(params, toks[:, prompt + i:prompt + i + 1].to(dev),
                                         cache, pos)
            out.append(logits.cpu())
    if caches is not None:
        caches.extend(t.cpu() for t in _leaves(cache))
    return out


def phase_small_model(torch, card: str, arch: str, overrides: dict, prompt: int, steps: int,
                      want: Dict[str, int], qk_fan_in: bool = False,
                      caches: bool = False) -> dict:
    """A small float32 model on the card against the same weights on the
    CPU, where the plain versions run (with ``caches``, also every cache leaf
    after the last step); the check's conditioning (how far a 1e-7 change of
    the embedding moves the CPU's logits) printed beside it."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced_config(arch), **overrides)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=DEVICE)
    params = fan_in_qk(cfg, cpu.init(torch.Generator().manual_seed(1)), qk_fan_in)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + steps), generator=g,
                         dtype=torch.int32)
    kernels.reset_launches()
    want_c, got_c = ([], []) if caches else (None, None)
    want_l = _serve_logits(torch, cpu, params, toks, prompt, steps, want_c)
    got_l = _serve_logits(torch, gpu, _to(params, DEVICE), toks, prompt, steps, got_c)
    counts = kernels.launch_counts()
    if counts != {k: want.get(k, 0) for k in kernels.KERNELS}:
        raise AssertionError(f"small {arch} launches {counts}, expected {want}")
    err = max(float((a - b).abs().max()) for a, b in zip(got_l, want_l))
    cache_err = None
    if caches:
        cache_err = max(float((a - b).abs().max()) for a, b in zip(got_c, want_c))
    nudged = _serve_logits(torch, cpu, _nudged(torch, params), toks, prompt, steps)
    cond = max(float((a - b).abs().max()) for a, b in zip(nudged, want_l))
    tol = 1e-4
    log(card, f"small f32 {cfg.name} ({cfg.n_layers} layers, {overrides}, wq/wk fan-in "
              f"{'d_model' if qk_fan_in else 'heads'}) "
              f"card vs CPU: max abs logit err {err:.3e} (tol {tol}) over prefill {prompt} + "
              f"{steps} decode steps; a 1e-7 change of the embedding moves the CPU's logits by "
              f"{cond:.3e}; launches {counts}"
              + ("" if cache_err is None else
                 f"; every cache leaf ({len(got_c)}) within max abs err {cache_err:.3e} "
                 f"(tol {tol})"))
    if err > tol or (cache_err is not None and cache_err > tol):
        raise AssertionError("the card disagrees with the CPU on a small model")
    return dict(arch=arch, max_abs_err=err, tol=tol, conditioning=cond, qk_fan_in=qk_fan_in,
                launches=counts, cache_max_abs_err=cache_err)


def _grads(torch, model, params, batch):
    """(loss, gradients) of ``model.loss`` by autograd, for a copy of ``params``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    it = iter(leaves)
    loss, _ = model.loss(_rebuild(params, it), batch, remat="full")
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def phase_small_train(torch, card: str, arch: str, overrides: dict, S: int,
                      qk_fan_in: bool) -> dict:
    """One float32 train step of a small model on the card against the same
    step on the CPU (the plain path). attn_chunk < S, so the flash forward
    and backward kernels run (for mamba2 the SSD scan's): loss, grad_norm
    and the MoE aux loss within 1e-4 relative,
    every gradient within 1e-4 of
    its leaf's largest magnitude (post-Adam parameters are not compared:
    Adam turns rounding noise on tiny gradients into lr-sized differences),
    and the launches of the step checked exactly."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(reduced_config(arch), **overrides)
    tol = 1e-4
    params = fan_in_qk(cfg, build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1)),
                       qk_fan_in)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_c, grads_c = _grads(torch, build_model(cfg, device="cpu"), params, batch)
    loss_g, grads_g = _grads(torch, build_model(cfg, device=DEVICE), _to(params, DEVICE),
                             _to(batch, DEVICE))
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
                   for g, c in zip(grads_g, grads_c))
    _, grads_n = _grads(torch, build_model(cfg, device="cpu"), _nudged(torch, params), batch)
    cond = max(float((n - c).abs().max() / c.abs().max().clamp(min=1e-30))
               for n, c in zip(grads_n, grads_c))
    out = {}
    for dev in ("cpu", DEVICE):
        _, step = make_train_step(cfg, peak_lr=1e-3, warmup=2, total=10, device=dev)
        p = _to(params, dev)
        kernels.reset_launches()
        _, _, m = step(p, adamw_init(p), _to(batch, dev), 1)
        out[dev] = dict(m, launches=kernels.launch_counts())
    want = {k: 0 for k in kernels.KERNELS}
    want.update(train_launches(cfg, S))
    if out[DEVICE]["launches"] != want:
        raise AssertionError(f"small train step launches {out[DEVICE]['launches']}, "
                             f"expected {want}")
    # relative, but the aux loss of a model without MoE layers is 0 on both
    step_err = {k: abs(float(out[DEVICE][k]) - float(out["cpu"][k]))
                / (abs(float(out["cpu"][k])) or 1.0) for k in ("loss", "grad_norm", "aux")}
    log(card, f"small f32 {cfg.name} ({cfg.n_layers} layers, {overrides}, wq/wk fan-in "
              f"{'d_model' if qk_fan_in else 'heads'}, "
              f"S={S}) train step, card vs CPU: loss rel err {loss_err:.3e}; a 1e-7 change of "
              f"the embedding moves the CPU's gradients by up to {cond:.3e} of a leaf's max; "
              f"worst gradient "
              f"{grad_err:.3e} of its leaf's max, train-step loss {step_err['loss']:.3e}, "
              f"grad_norm {step_err['grad_norm']:.3e} and aux {step_err['aux']:.3e} (aux "
              f"{float(out['cpu']['aux']):.6f} on the CPU) relative (tol {tol}); launches "
              f"{out[DEVICE]['launches']}")
    if max(loss_err, grad_err, *step_err.values()) > tol:
        raise AssertionError("the card's train step disagrees with the CPU's")
    return dict(arch=arch, overrides=overrides, qk_fan_in=qk_fan_in, loss_rel_err=loss_err,
                grad_rel_err=grad_err, conditioning=cond, step_rel_err=step_err, tol=tol,
                launches=out[DEVICE]["launches"])


def _fill_like(tree, value: float):
    """Tensors like ``tree``'s leaves, filled with ``value``."""
    if isinstance(tree, dict):
        return {k: _fill_like(v, value) for k, v in tree.items()}
    return tree.detach().new_full(tree.shape, value)


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (parameters in matrix
    products: the layers' projections (attention's, or the RG-LRU block's)
    and MLP and the head; the embedding is a lookup) x tokens, plus the
    attention layers' scores and P V (4 d operations a live pair and head)
    three times (forward and backward; the RG-LRU scan's few operations an
    element are not counted); for an SSM
    (mamba2) the layers' in and out projections and the SSD scan's linear
    form (``kernels/flops.ssd_scan_flops``) three times; for the
    encoder-decoder also the encoder over its frames (non-causal), the
    cross-attention's K/V projections over the frames and its scores (every
    token against every frame); for a VLM the layers and the head run over
    the patches too, and the prefix's pairs above the diagonal are live; an
    MoE layer counts its active parameters (router, K experts, shared
    experts), MLA its projections and its pairs' (dn + dr)- and dv-wide
    products. The recomputation of remat="full" is not counted."""
    if cfg.ssm:
        from repro_torch.kernels import flops
        d, din, gn, nh = cfg.d_model, cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, \
            cfg.ssm_nheads
        per_layer = d * (2 * din + 2 * gn + nh) + din * d
        ssd = flops.ssd_scan_flops(batch, seq, nh, cfg.ssm_headdim, cfg.ssm_ngroups,
                                   cfg.ssm_state)
        return 6.0 * (cfg.n_layers * per_layer + d * cfg.padded_vocab) * batch * seq \
            + 3 * ssd * cfg.n_layers
    from repro_torch.models import build_model
    d, h, kv, hd, w = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.lru_dim
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    qo, kvp = 2 * d * h * hd, 2 * d * kv * hd       # a layer's q and o, k and v projections
    if cfg.encdec:
        T, L, E = cfg.enc_seq, cfg.n_layers, cfg.n_enc_layers
        matmul_tokens = E * (qo + kvp + mlp) * T + L * ((2 * qo + kvp + mlp) * seq + kvp * T) \
            + d * cfg.padded_vocab * seq
        pairs = E * T * T + L * (live_pairs(seq, seq, True, None) + seq * T)
        return 6.0 * matmul_tokens * batch + 3 * 4 * hd * h * batch * pairs
    P = prefix_slots(cfg)         # training's prefix is the patches (LM.apply)
    seq += P
    if cfg.mla:      # wq_a, wq_nope/wq_rope, wkv_a, wk_nope/wv, wo; a pair's q.k and p.v
        rq, rkv, dn, dr, dv = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim, \
            cfg.qk_rope_dim, cfg.v_head_dim
        attn_proj = d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv) \
            + h * dv * d
        pair_ops = 2 * (dn + dr) + 2 * dv
    else:
        attn_proj, pair_ops = 2 * d * h * hd + 2 * d * kv * hd, 4 * hd
    mixer = {"dense": attn_proj, "local_attn": attn_proj, "moe": attn_proj,
             "dense_mlp": attn_proj,
             "rec": 3 * d * w + 2 * w * w}       # RG-LRU: w_in, gate branch, w_out; wa, wx
    # an MoE layer's active parameters: the router, K of E experts' three products
    # and the shared experts (the dispatch's empty and dropped rows not counted)
    moe = d * cfg.n_experts + cfg.experts_per_token * 3 * d * cfg.moe_d_ff \
        + cfg.n_shared_experts * (3 if cfg.gated_mlp else 2) * d * cfg.moe_d_ff
    kinds = build_model(cfg, device="cpu").layer_kinds()
    matmul = sum(mixer[k] + (moe if k == "moe" else mlp) for k in kinds) \
        + d * cfg.padded_vocab
    n_attn = sum(k != "rec" for k in kinds)
    pairs = live_pairs(seq, seq, True, cfg.window) + P * (P - 1) // 2
    attn = 3 * pair_ops * h * batch * pairs * n_attn
    return 6.0 * matmul * batch * seq + attn


def moe_rows_share(cfg, batch: int, seq: int) -> float:
    """The rows the expert products compute (E x C a dispatch group, dropped
    and empty slots included) over the routed (token, slot)s, K x T: the
    capacity overhead that ``train_flops`` does not count."""
    from repro_torch.models.mlp import dispatch_groups, moe_capacity
    T = batch * seq
    G = dispatch_groups(T, cfg)
    return cfg.n_experts * moe_capacity(cfg, T // G) * G / (cfg.experts_per_token * T)


@dataclasses.dataclass(frozen=True)
class TrainPath:
    """One training path: the arch at full width, its depth (None: full),
    batch x sequence, steps, and whether a Checkpointer round trip of the
    trained state follows."""
    arch: str
    layers: Optional[int]
    batch: int
    seq: int
    steps: int
    checkpoint: bool
    qk_fan_in: bool = False   # wq and wk at the fan-in of d_model (see fan_in_qk)
    compress: bool = False    # ef_compress over the trained state's gradients, card vs CPU


TRAIN_PATHS = [
    TrainPath("qwen3_32b", TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, True),
    # full depth; S = 8192 above the 4096 window, which binds in both kernels;
    # wq and wk at the fan-in of d_model (the reference init's first grad norm
    # is printed beside the run)
    TrainPath("h2o_danube_1_8b", None, H2O_TRAIN_BATCH, H2O_TRAIN_SEQ, TRAIN_STEPS, False,
              True),
    # all 48 SSD layers: the ssd_scan forward and backward kernels
    TrainPath("mamba2_780m", None, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, TRAIN_STEPS, False),
    # 8 of 38 layers: the RG-LRU scan's and, above the 2048 window, the d = 256 flash
    # forward and backward kernels; wq and wk at the fan-in of d_model
    TrainPath("recurrentgemma_9b", RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_SEQ, TRAIN_STEPS,
              False, True),
    # all 12 + 12 layers, 448 decoder tokens over 1500 frames: below attn_chunk, the
    # encoder and the cross-attention plain, so no kernel launches: EncDecLM.loss under
    # autograd and AdamW on the card. No qk-norm: wq and wk at the fan-in of d_model
    TrainPath("whisper_small", None, WH_TRAIN_BATCH, WH_TRAIN_SEQ, TRAIN_STEPS, False, True),
    # 4 of 18 layers, 256 patches + 512 tokens: the prefix keeps attention off flash,
    # so no kernel launches: the prefix loss (patch rows carry none). wq and wk at the
    # fan-in of d_model, as whisper's
    TrainPath("paligemma_3b", PG_TRAIN_LAYERS, PG_TRAIN_BATCH, PG_TRAIN_SEQ, TRAIN_STEPS, False,
              True),
    # 8 of 16 MoE layers (64 experts top-8 at the reference's capacity factor 1.25),
    # S = 4096 above attn_chunk: the flash forward and backward at G = 1, d = 128, 16
    # forwards (forward and recompute of 8 stacked units) and 8 backwards a step; then
    # ef_compress over the trained state's gradients on the card against the CPU
    TrainPath("olmoe_1b_7b", OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, TRAIN_STEPS,
              False, compress=True),
]


def phase_train(torch, card: str, path: TrainPath) -> dict:
    """An arch at full width trained on the card through the user's entry
    points (``make_train_step`` with remat="full", fed by ``TokenPipeline``),
    then, where the path asks for it, a Checkpointer round trip of the
    trained state (parameters and optimizer state) that must restore bit
    for bit."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    full = get_config(path.arch)
    cfg = dataclasses.replace(full, n_layers=path.layers or full.n_layers)
    B, S, steps = path.batch, path.seq, path.steps
    model, train_step = make_train_step(cfg, peak_lr=3e-4, warmup=2, total=steps,
                                        remat="full", device=DEVICE)
    params = fan_in_qk(cfg, model.init(torch.Generator(device=DEVICE).manual_seed(0)),
                       path.qk_fan_in)
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in _leaves(params))
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves({"p": params, "o": opt}))
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                    seed=0), device=DEVICE)
    stubs = stubs_for(torch, cfg, B)        # whisper's frames, paligemma's patches
    width = (f"{cfg.ssm_nheads} SSD heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk}" if cfg.ssm else f"{cfg.n_heads} heads on {cfg.n_kv_heads} KV "
             f"heads of {cfg.hd}, d_ff {cfg.d_ff}"
             + (f", lru width {cfg.lru_dim}, layers {'/'.join(model.layer_kinds())}"
                if "rec" in cfg.block_pattern else "")
             + (f", {cfg.n_experts} experts top-{cfg.experts_per_token} of d_ff "
                f"{cfg.moe_d_ff} at capacity factor {cfg.capacity_factor}"
                if cfg.n_experts else ""))
    log(card, f"training {cfg.name} at full width (d_model {cfg.d_model}, {width}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}), {cfg.n_layers} of {full.n_layers} layers: "
              f"{n_params / 1e9:.3f} B "
              f"parameters, {state_bytes / 1e9:.2f} GB with the AdamW state; batch {B} x {S}"
              + (f" over {cfg.enc_seq} encoder frames ({cfg.n_enc_layers} encoder layers)"
                 if cfg.encdec else "")
              + (f" after {prefix_slots(cfg)} patches" if cfg.vision_stub else "")
              + f", window {cfg.window}, remat='full', {steps} steps, peak lr 3e-4, warmup 2, "
              f"wq/wk "
              f"fan-in {'d_model' if path.qk_fan_in else 'heads (the reference init)'}")
    per_step = {k: 0 for k in kernels.KERNELS}
    per_step.update(train_launches(cfg, S))
    batch = {**next(data), **stubs}
    # an MoE model: the share of routed (token, slot)s that the first batch drops
    # before training and a fresh batch after it (untimed forwards, no launch counted)
    drop_shares = [drop_share(torch, model, params, batch)] if cfg.n_experts else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_ms, metrics = [], [], []
    for step in range(steps):
        if step:
            batch = {**next(data), **stubs}
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, batch, step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError(f"train step {step} launched {got}, expected {per_step}")
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {step}: {m}")
        losses.append(m["loss"])
        metrics.append(m)
        log(card, f"{cfg.name} train step {step}: loss {m['loss']:.4f} (nll {m['nll']:.4f}), "
                  f"grad_norm {m['grad_norm']:.3f}, clip {m['clip_scale']:.4f}, lr "
                  f"{m['lr']:.3e}, {step_ms[-1]:.1f} ms"
                  + (f", aux {m['aux']:.5f}" if cfg.n_experts else ""))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    batch = {**next(data), **stubs}
    if cfg.n_experts:
        drop_shares.append(drop_share(torch, model, params, batch))
    alloc = torch.cuda.memory_stats()
    retries, reserved = alloc.get("num_alloc_retries", 0), alloc.get("reserved_bytes.all.peak", 0)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    med = statistics.median(step_ms[2:])
    flops = train_flops(cfg, B, S)
    tok_s = B * S / med * 1e3
    mfu = flops / (med / 1e3) / PEAK_OPS["bfloat16"]
    log(card, f"{cfg.name} training: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {med:.1f} ms "
              f"(median of steps 2-{steps - 1}), {tok_s:.0f} tokens/s, model FLOPs "
              f"{flops / 1e12:.2f} TFLOP a step (6 x matmul parameters x tokens + 3 x attention's "
              f"forward; remat's recompute not counted), {100 * mfu:.1f}% of 989 TFLOP/s; peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), {reserved / 2**30:.2f} "
              f"GiB reserved, {retries} allocation retries (the caching allocator freed its "
              f"cache and synchronised); launches over {steps} steps {counts}")
    if cfg.n_experts:
        log(card, f"{cfg.name} training: the expert products compute "
                  f"{moe_rows_share(cfg, B, S):.4f} x the routed (token, slot)s' rows (E x C x "
                  f"G / (K x T), capacity overhead not in the model FLOPs); dropped slots "
                  f"{100 * drop_shares[0]:.2f}% of step 0's batch before training, "
                  f"{100 * drop_shares[-1]:.2f}% of a fresh batch after step {steps - 1} "
                  f"(untimed forwards)")
    groups = {"ssd_scan forward": ("ssd_cb_", "ssd_chunk_state_", "ssd_state_passing_",
                                   "ssd_chunk_scan_"), "ssd_scan backward": "ssd_bwd_"} \
        if cfg.ssm else {"flash_attention forward": "flash_wgmma_kernel",
                         "flash_attention backward": "flash_bwd_"}
    if "rec" in cfg.block_pattern:
        groups.update({"rglru_scan forward": "rglru_kernel", "rglru_scan backward": "rglru_bwd_kernel"})
    prof = profile(torch, lambda: train_step(params, opt, batch, steps), card,
                   f"one {cfg.name} train step ({B}x{S})", groups=groups)
    compress_batch = {**next(data), **stubs} if path.compress else None
    data.close()
    del batch
    out = dict(config=full.name, n_layers=cfg.n_layers, full_layers=full.n_layers,
               params=n_params, state_bytes=state_bytes, batch=B, seq=S, window=cfg.window,
               steps=steps, losses=losses, metrics=metrics, step_ms=step_ms, step_ms_median=med,
               tokens_s=tok_s, model_flops=flops, mfu=mfu, peak_bytes=peak, launches=counts,
               launches_per_step=per_step, profile=prof, alloc_retries=retries,
               reserved_peak_bytes=reserved)
    if cfg.n_experts:
        out.update(drop_shares=drop_shares, expert_rows_share=moe_rows_share(cfg, B, S))

    if path.checkpoint:
        out["checkpoint"] = checkpoint_round_trip(torch, card, cfg.name, steps, params, opt)

    # the optimizer's share of a step: one AdamW update of the trained state alone
    from repro_torch.optim import adamw_update
    grads = _fill_like(params, 1e-3)
    out["profile_adamw"] = profile(torch, lambda: adamw_update(grads, opt, params, 1e-5), card,
                                   f"one AdamW update of the {n_params / 1e9:.3f} B parameters")
    del grads, opt
    gc.collect()
    torch.cuda.empty_cache()
    if path.compress:
        out["compress"] = compress_check(torch, card, cfg.name, model, params, compress_batch)
        del compress_batch
    del params                    # the trained state is not needed past here
    gc.collect()
    torch.cuda.empty_cache()
    if path.qk_fan_in:      # the first batch's gradient with the reference init's wq and wk
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                        seed=0), device=DEVICE)
        batch = {**next(data), **stubs}
        data.close()
        ref_params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        loss_ref, grads_ref = _grads(torch, model, ref_params, batch)
        norm = float(torch.sqrt(sum(g.float().pow(2).sum() for g in grads_ref)))
        out["reference_init"] = dict(loss=float(loss_ref), grad_norm=norm)
        log(card, f"{cfg.name} with the reference init's wq and wk (fan-in read from the head "
                  f"axis): the first batch's loss {float(loss_ref):.4f}, grad_norm {norm:.4g} "
                  f"(against {metrics[0]['grad_norm']:.4g} above; the clip to 1 then leaves "
                  f"updates of ~{1 / norm:.1g} of the gradient)")
        del ref_params, grads_ref, batch
    return out


COMPRESS_NORM_TOL = 1e-5     # relative: the residual norm sums its leaves in another order


def compress_check(torch, card: str, name: str, model, params, batch) -> dict:
    """``ef_compress`` over the gradients of one batch of the trained
    parameters on the card: a first call from the zero residual, then a
    second that carries the first's residual, held against the same second
    call on CPU copies of its inputs, a leaf at a time: every dequantised
    gradient and residual bit for bit (one float32 division, a half-to-even
    round, exact products and differences on both devices), the residual
    norm within ``COMPRESS_NORM_TOL`` (float32 sums in another order). One
    call is compared: the CPU's side of it takes about a minute."""
    from repro_torch.optim import ef_compress, ef_init
    leaves = list(_leaves(params))         # they require grad since the train step
    loss, _ = model.loss(params, batch, remat="full")
    grads = _rebuild(params, iter(torch.autograd.grad(loss, leaves)))
    del loss
    _, ef, first = ef_compress(grads, ef_init(grads))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deq, new_ef, m = ef_compress(grads, ef)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    equal, sq = True, 0.0
    for g, e, d, r in zip(_leaves(grads), _leaves(ef), _leaves(deq), _leaves(new_ef)):
        d_c, r_c, _ = ef_compress({"x": g.cpu()}, {"x": e.cpu()})
        equal &= bool(torch.equal(d.cpu(), d_c["x"]) and torch.equal(r.cpu(), r_c["x"]))
        sq += float(torch.sum(torch.square(r_c["x"])))
    cpu_s = time.perf_counter() - t0
    norm, cpu_norm = float(m["ef_residual_norm"]), math.sqrt(sq)
    err = abs(norm - cpu_norm) / cpu_norm
    out = dict(leaves=len(leaves), elements=sum(t.numel() for t in leaves), card_ms=card_ms,
               cpu_s=cpu_s, equal=equal, first_norm=float(first["ef_residual_norm"]), norm=norm,
               cpu_norm=cpu_norm, norm_rel_err=err, norm_tol=COMPRESS_NORM_TOL)
    log(card, f"{name} ef_compress over the gradients of {out['leaves']} leaves "
              f"({out['elements'] / 1e9:.3f} B elements), the call carrying the first call's "
              f"residual (norm {out['first_norm']:.6g}): {card_ms:.1f} ms on the card (host "
              f"clock); dequantised gradients and residuals "
              f"{'equal bit for bit to' if equal else 'DIFFERENT from'} the same call's on CPU "
              f"copies ({cpu_s:.1f} s); residual norm {norm:.6g}, within {err:.2e} of the "
              f"CPU's (tol {COMPRESS_NORM_TOL})")
    if not equal or not err <= COMPRESS_NORM_TOL:
        raise AssertionError(f"ef_compress on the card disagrees with the CPU: {out}")
    return out


def checkpoint_round_trip(torch, card: str, name: str, step: int, params, opt) -> dict:
    """The trained state through the checkpointer and back onto the card, in
    three parts so the card holds at most one part twice; every restored
    leaf must equal the trained one bit for bit."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    state = {"params": params, "opt": opt}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, async_save=True)
        t0 = time.perf_counter()
        ckpt.save(step, state)
        ckpt.wait()
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(tmp)
                      for f in files)
        t0 = time.perf_counter()
        for part in ({"params": params}, {"opt": {"m": opt["m"]}},
                     {"opt": {"v": opt["v"], "count": opt["count"]}}):
            back = ckpt.restore(step, part)
            for a, b in zip(_leaves(part), _leaves(back)):
                if not (b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)):
                    raise AssertionError("a restored leaf differs from the trained state")
            del back
        restore_s = time.perf_counter() - t0
    log(card, f"{name} checkpoint round trip: {written / 1e9:.2f} GB written in {save_s:.1f} s "
              f"(async save, then wait), restored onto the card and equal bit for bit in "
              f"{restore_s:.1f} s")
    return dict(bytes=written, save_s=save_s, restore_s=restore_s)


def phase_grads(torch, card: str) -> dict:
    """deepseek-v2-236b's loss and gradients at full width through
    ``LM.loss`` (remat="full") and autograd, with no optimizer: its
    dense-first tail and two stacked MoE units hold ~9.3 B parameters, whose
    AdamW state would not fit beside them on one card. ``DS_GRAD_PASSES``
    passes timed on the host clock (median), then one profiled; every
    gradient finite, no kernel launched (MLA takes neither kernel), the
    model-FLOP share of 989 TFLOP/s, the peak memory, and the routed slots'
    drop share from one untimed forward after the timed passes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model

    batch, seq, passes = DS_GRAD_BATCH, DS_GRAD_SEQ, DS_GRAD_PASSES
    full = get_config("deepseek_v2_236b")
    cfg = dataclasses.replace(full, n_layers=DS_GRAD_LAYERS)
    model = build_model(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    n_params = sum(t.numel() for t in leaves)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    seed=0), device=DEVICE)
    tokens = next(data)
    data.close()
    unit, n_units, tail = model.scan_groups()
    log(card, f"{cfg.name} loss and gradients at full width (d_model {cfg.d_model}, "
              f"{cfg.n_heads} MLA heads, kv rank {cfg.kv_lora_rank}, {cfg.n_experts} experts "
              f"top-{cfg.experts_per_token} + {cfg.n_shared_experts} shared at capacity factor "
              f"{cfg.capacity_factor}), {cfg.n_layers} of {full.n_layers} layers (tail "
              f"{'/'.join(tail)} first, {n_units} stacked {'/'.join(unit)} units): "
              f"{n_params / 1e9:.3f} B parameters; batch {batch} x {seq} (MLA's query chunks of "
              f"{cfg.attn_chunk // 4} under the units' remat), {cfg.dtype}, no optimizer")

    def grads():
        loss, met = model.loss(params, tokens, remat="full")
        return loss.detach(), met["aux"].detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ms, losses = [], []
    for i in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, g = grads()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        finite = bool(torch.stack([torch.isfinite(x).all() for x in g]).all())
        norm = float(torch.sqrt(sum(x.float().pow(2).sum() for x in g)))
        losses.append(float(loss))
        log(card, f"{cfg.name} gradients pass {i}: loss {float(loss):.4f}, aux "
                  f"{float(aux):.5f}, grad norm {norm:.4g}, every gradient finite: {finite}, "
                  f"{ms[-1]:.1f} ms")
        if not (finite and math.isfinite(float(loss))):
            raise AssertionError(f"{cfg.name}: a non-finite loss or gradient")
        del g
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dropped = drop_share(torch, model, params, tokens)
    if any(counts.values()):
        raise AssertionError(f"{cfg.name}'s gradients launched {counts}: MLA takes no kernel")
    med = statistics.median(ms)
    flops = train_flops(cfg, batch, seq)
    mfu = flops / (med / 1e3) / PEAK_OPS["bfloat16"]
    log(card, f"{cfg.name} gradients: {med:.1f} ms (median of {passes} passes), "
              f"{batch * seq / med * 1e3:.0f} tokens/s, model FLOPs {flops / 1e12:.2f} TFLOP a "
              f"pass, {100 * mfu:.1f}% of 989 TFLOP/s; the expert products compute "
              f"{moe_rows_share(cfg, batch, seq):.4f} x the routed rows; "
              f"{100 * dropped:.2f}% of routed slots dropped (an untimed forward); peak memory "
              f"{peak / 2**30:.2f} GiB; launches {counts}")
    prof = profile(torch, grads, card, f"one {cfg.name} loss-and-gradients pass ({batch}x{seq})")
    out = dict(config=full.name, n_layers=cfg.n_layers, full_layers=full.n_layers,
               params=n_params, batch=batch, seq=seq, ms=ms, ms_median=med, losses=losses,
               model_flops=flops, mfu=mfu, peak_bytes=peak, launches=counts,
               dropped_share=dropped, expert_rows_share=moe_rows_share(cfg, batch, seq),
               profile=prof)
    del params, leaves, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the train launcher's run on the card: the reduced recurrentgemma (remat "none",
# batch 8 x 128, below attn_chunk: the RG-LRU scan's kernels alone)
TRAIN_LAUNCHER_ARGS = ["--arch", "recurrentgemma_9b", "--reduced", "--steps", "20"]


def phase_train_launcher(torch, card: str, args=TRAIN_LAUNCHER_ARGS) -> dict:
    """``python -m repro_torch.launch.train`` on the card, through its
    ``main`` in this process so that its launches can be counted: the loss
    must fall, and every rec layer must launch the RG-LRU scan forward and
    backward once a step (the launcher trains with remat="none")."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train as ttrain
    from repro_torch.models import build_model

    n_rec = build_model(reduced_config(args[1]), device="cpu").layer_kinds().count("rec")
    steps = int(args[args.index("--steps") + 1])
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = ttrain.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {k: 0 for k in kernels.KERNELS}
    want.update(rglru_scan=steps * n_rec, rglru_scan_bwd=steps * n_rec)
    log(card, f"train launcher {' '.join(args)}: loss {out['first']:.4f} -> {out['final']:.4f} "
              f"(means of the first and last 10 steps), {wall_s:.1f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"the train launcher launched {counts}, expected {want}")
    if not (all(math.isfinite(x) for x in out["losses"]) and out["final"] < out["first"]):
        raise AssertionError(f"the train launcher's loss did not fall: {out['losses']}")
    return dict(args=args, first=out["first"], final=out["final"], losses=out["losses"],
                wall_s=wall_s, launches=counts)


# ==============================================================================
# phase 6: a Dora plan on the card
# ==============================================================================
# the small float32 h2o-family model that runs the gradients plan card against
# CPU: 8 layers (3/2/2/1 on the four stages), attn_chunk 64 < S = 256, window 96
PIPE_SMALL, PIPE_SMALL_SEQ = dict(head_dim=80, n_layers=8, attn_chunk=64, window=96), 256
# the serve launcher's run: h2o-danube-1.8b at full depth on edge_cluster
LAUNCHER_ARCH, LAUNCHER_GEN = "h2o_danube_1_8b", 32
LAUNCHER_ARGS = ["--arch", LAUNCHER_ARCH, "--prompt-len", str(PLAN_SEQ), "--gen-len",
                 str(LAUNCHER_GEN), "--setting", "edge_cluster", "--dynamics"]
# the catalogue part: a registered scenario beyond Table 3 (four genio520 boards on
# V2V links, two link events in its timeline), served by the launcher, granite-8b
# planned on it with the forward plan's workload and replanned by the control
# plane, then the scenario CLI and ``compare`` (host code)
CATALOGUE = "vehicle_platoon"
CATALOGUE_LAUNCHER_ARGS = LAUNCHER_ARGS[:-3] + ["--setting", CATALOGUE, "--dynamics"]
CATALOGUE_STRATEGIES = ["dora", "throughput_max", "chain_split"]


def phase_plan(torch, card: str, what: str) -> dict:
    """Plan one of ``PLANS`` with the port's planner (host code) and derive
    the executor's stage layout; fails below two stages."""
    from repro_torch import dora
    from repro_torch.configs import get_config
    from repro_torch.core import QoESpec, Workload
    from repro_torch.models.registry import planning_graph
    from repro_torch.runtime.pipeline import PipelineSpec

    arch, setting, (gb, mb, training), (t_qoe, lam) = PLANS[what]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    session = dora.serve(setting, graph=planning_graph(cfg, PLAN_SEQ),
                         qoe=QoESpec(t_qoe=t_qoe, lam=lam),
                         workload=Workload(global_batch=gb, microbatch_size=mb, training=training))
    wall = time.perf_counter() - t0
    res, plan = session.report.result, session.current
    spec = PipelineSpec.from_plan(plan, cfg.n_layers)
    log(card, f"Dora plan of {cfg.name} on {setting} ({'train' if training else 'serve'}: batch "
              f"{gb} of {mb}, t_qoe {t_qoe} s, lambda {lam}, sequence {PLAN_SEQ}): "
              f"{plan.summary()}; {spec}; planning took {res.total_s * 1e3:.1f} ms (phase1 "
              f"{res.phase1_s * 1e3:.1f} ms, phase2 {res.phase2_s * 1e3:.1f} ms; "
              f"{wall * 1e3:.1f} ms with the graph) of the host CPU, not card time")
    if plan.n_stages < 2:
        raise AssertionError(f"the {what} plan has {plan.n_stages} stage(s), expected two or more")
    if plan.microbatch_size != mb:
        raise AssertionError(f"the {what} plan's microbatch is {plan.microbatch_size}, not the "
                             f"{mb} at which phase 2 holds its kernels")
    return dict(arch=arch, setting=setting, cfg=cfg, plan=plan, spec=spec,
                summary=plan.summary(), layers_per_stage=list(spec.layers_per_stage),
                n_microbatches=spec.n_microbatches, microbatch_size=plan.microbatch_size,
                planning_s=res.total_s, planning_wall_s=wall)


def _named(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, in ``_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _wall_ms(torch, fn) -> float:
    """Host-clock ms of one ``fn()`` call, between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _hold(torch, what: str, out, exp, dt: str, floor: float = 0.0):
    """``check`` with ``what`` in its failure."""
    try:
        return check(torch, out, exp, dt, floor)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def phase_pipeline_forward(torch, card: str, planned: dict, keep: Optional[dict] = None) -> dict:
    """The forward plan's model at full width and depth through the
    executor on the card (bf16, no grad), held against the same layers
    applied microbatch by microbatch in plain order; launches exact.
    ``keep`` receives the output on the host (``out``)."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DoraPipelineExecutor

    cfg, plan = planned["cfg"], planned["plan"]
    model = build_model(cfg, device=DEVICE)
    params = fan_in_qk(cfg, model.init(torch.Generator(device=DEVICE).manual_seed(0)))
    n_params = sum(t.numel() for t in _leaves(params))

    def layer_fn(lp, x):
        return apply_block(lp, x, cfg, "dense", mode="train")
    ex = DoraPipelineExecutor(plan, cfg.n_layers, layer_fn)
    spec = ex.spec
    M, mb = spec.n_microbatches, plan.microbatch_size
    toks = torch.randint(0, cfg.vocab_size, (M * mb, PLAN_SEQ), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(1))
    stack = params["stack"]["u0"]
    # the reference reads layer i of the unpacked stack, so it does not share the packing
    layers = [_rebuild(stack, (t[i] for t in _leaves(stack))) for i in range(cfg.n_layers)]

    def plain():
        ys = []
        for m in range(M):
            y = x[m]
            for lp in layers:
                y = layer_fn(lp, y)
            ys.append(y)
        return torch.stack(ys)
    with torch.no_grad():
        x = params["embed"][toks].view(M, mb, PLAN_SEQ, cfg.d_model)
        ref = plain()
        plain_ms = [_wall_ms(torch, plain) for _ in range(3)]
        packed = ex.pack_params(stack)
    packed_bytes = sum(t.numel() * t.element_size() for t in _leaves(packed))
    del params, stack, layers       # the unpacked stack goes; the packed tree stays
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with torch.no_grad():
        out = ex.forward(packed, x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in kernels.KERNELS}
    want["flash_attention"] = cfg.n_layers * M
    if counts != want:
        raise AssertionError(f"pipeline forward launched {counts}, expected {want}")
    with torch.no_grad():
        if out.shape != (M, mb, PLAN_SEQ, cfg.d_model) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"pipeline output {tuple(out.shape)} is not finite or misshaped")
        bitwise = bool(torch.equal(out, ref))
        err, share = _hold(torch, "pipeline forward against the plain order", out, ref, "bfloat16")
        if keep is not None:
            keep["out"] = out.cpu()
        del out, ref
        ex_ms = [_wall_ms(torch, lambda: ex.forward(packed, x)) for _ in range(3)]
    med_ex, med_plain = statistics.median(ex_ms), statistics.median(plain_ms)
    log(card, f"pipeline forward of {cfg.name} at full width and depth ({cfg.n_layers} layers, "
              f"{n_params / 1e9:.2f} B parameters, {cfg.dtype}, wq/wk fan-in d_model) on the "
              f"{planned['setting']} plan's {spec.n_stages} stages {spec.layers_per_stage} (pad "
              f"{spec.pad}, packed {packed_bytes / 1e9:.2f} GB), {M} microbatches of {mb} x "
              f"{PLAN_SEQ}: against the plain order microbatch by microbatch "
              f"{'bitwise equal' if bitwise else 'not bitwise equal'}, max abs err {err:.3e}, "
              f"{share:.3g} of the bound ({TOL['bfloat16']}); launches {counts}; executor "
              f"{med_ex:.1f} ms against the plain order's {med_plain:.1f} ms (median of 3 each, "
              f"the plain passes first, host clock around torch.cuda.synchronize); peak memory {peak / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated over the checked forward)")
    del packed, x
    return dict(arch=planned["arch"], n_layers=cfg.n_layers, params=n_params,
                layers_per_stage=list(spec.layers_per_stage), pad=spec.pad,
                n_microbatches=M, microbatch_size=mb, seq=PLAN_SEQ, bitwise=bitwise,
                max_abs_err=err, bound_share=share, launches=counts, executor_ms=ex_ms,
                plain_ms=plain_ms, executor_ms_median=med_ex, plain_ms_median=med_plain,
                peak_bytes=peak, packed_bytes=packed_bytes)


def pipeline_tree(ex, params) -> dict:
    """``params`` with the stack packed for ``ex`` (under ``"packed"``)."""
    top = {k: v for k, v in params.items() if k not in ("stack", "tail")}
    return dict(top, packed=ex.pack_params(params["stack"]["u0"]))


def pipeline_grads(torch, model, ex, tree, batch, seq: int):
    """The executor's training loss (embed → executor → final norm, head
    and NLL, applied once to the whole output) and its gradients by
    autograd, for ``tree`` (``pipeline_tree``): (loss, {path: gradient}
    with the packed stack's unpacked to (L, ...), whether every padded
    slot's gradient is exactly zero)."""
    spec = ex.spec
    M = spec.n_microbatches
    B = batch["tokens"].shape[0]
    mb = B // M
    d = model.cfg.d_model
    named = list(_named(tree))
    leaves = [t.detach().requires_grad_(True) for _, t in named]
    p = _rebuild(tree, iter(leaves))
    x = p["embed"][batch["tokens"].long()].view(M, mb, seq, d)
    loss = ex.loss(p["packed"], x,
                   lambda o: model.loss_from_hidden(p, o.reshape(B, seq, d), batch))
    grads = torch.autograd.grad(loss, leaves)
    out, padded_zero = {}, True
    for (path, _), g in zip(named, grads):
        if path.startswith("/packed/"):
            padded_zero &= all(bool((g[s, n:] == 0).all())
                               for s, n in enumerate(spec.layers_per_stage))
            out["/stack/u0/" + path[len("/packed/"):]] = ex.unpack_params(g)
        else:
            out[path] = g
    return loss.detach(), out, padded_zero


PIPE_GRAD_TOL = 1e-4     # float32: every gradient within this share of its leaf's max
# bf16: the executor's gradients may use at most this multiple of the share of the
# backward's bound that LM.loss's bf16 gradients use, both against LM.loss in float32
PIPE_BF16_RATIO = 1.5


def _rel_to_max(torch, got: dict, ref: dict):
    """(worst leaf, its max abs error over the leaf's max magnitude)."""
    errs = {k: float((got[k].float() - ref[k].float()).abs().max()
                     / ref[k].float().abs().max().clamp(min=1e-30)) for k in ref}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _worst_share(torch, got: dict, ref: dict):
    """(worst leaf, max abs err, share) of the bf16 backward's bound."""
    rows = {k: bound_share(torch, got[k], ref[k], "bfloat16", BWD_FLOOR) for k in ref}
    worst = max(rows, key=lambda k: rows[k][1])
    return (worst,) + rows[worst]


def phase_pipeline_grads(torch, card: str, planned: dict, keep: Optional[dict] = None) -> dict:
    """The gradients plan's model at full width and depth trained through
    the executor on the card (each stage remat'd), against
    ``LM.loss(remat="full")`` on the same batch: in bf16 the launches (exact),
    the padded slots' zero gradients, the loss within the bf16 bound and
    the times; then in float32 (TF32 off) the loss and every gradient
    within ``PIPE_GRAD_TOL`` of its leaf's largest magnitude. The bf16
    gradients cannot be held to the backward's bound against bf16
    ``LM.loss`` (at this depth ``LM.loss`` misses it against a rerun of
    itself: bf16 dq is summed in another order each run); both bf16
    gradient sets are held against float32 ``LM.loss`` instead, and the
    executor's share of the bound may be at most ``PIPE_BF16_RATIO`` times
    ``LM.loss``'s. ``keep`` receives, on the host, the float32 executor's
    loss and gradients (``loss``, ``grads``), float32 ``LM.loss``'s
    gradients (``lm_grads``) and the bf16 gate's share limit
    (``bf16_limit``)."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DoraPipelineExecutor

    plan = planned["plan"]
    out, kept = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(planned["cfg"], dtype=dtype)
        model = build_model(cfg, device=DEVICE)
        params = fan_in_qk(cfg, model.init(torch.Generator(device=DEVICE).manual_seed(0)))
        ex = DoraPipelineExecutor(plan, cfg.n_layers,
                                  lambda lp, x, cfg=cfg: apply_block(lp, x, cfg, "dense",
                                                                     mode="train"))
        spec = ex.spec
        B = spec.n_microbatches * plan.microbatch_size
        toks = torch.randint(0, cfg.vocab_size, (B, PLAN_SEQ + 1), device=DEVICE,
                             dtype=torch.int32,
                             generator=torch.Generator(device=DEVICE).manual_seed(2))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        names = [path for path, _ in _named(params)]
        res = {}

        def reference():
            loss, grads = _grads(torch, model, params, batch)
            res["ref"] = (loss, dict(zip(names, grads)))

        def pipeline():
            res["pipe"] = pipeline_grads(torch, model, ex, tree, batch, PLAN_SEQ)
        ref_ms = [_wall_ms(torch, reference)]
        loss_ref, grads_ref = res.pop("ref")
        with torch.no_grad():
            tree = pipeline_tree(ex, params)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        ex_ms = [_wall_ms(torch, pipeline)]
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        loss, grads, padded_zero = res.pop("pipe")
        want = {k: 0 for k in kernels.KERNELS}
        want.update(flash_attention=2 * cfg.n_layers * spec.n_microbatches,
                    flash_attention_bwd=cfg.n_layers * spec.n_microbatches)
        if counts != want:
            raise AssertionError(f"pipeline gradients ({dtype}) launched {counts}, expected {want}")
        if not padded_zero:
            raise AssertionError(f"a padded slot's gradient is not zero ({dtype})")
        if sorted(grads) != sorted(grads_ref):
            raise AssertionError(f"gradient leaves {sorted(grads)} != {sorted(grads_ref)}")
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            raise AssertionError(f"pipeline gradients ({dtype}) are not finite")
        rec = dict(loss=float(loss), loss_ref=float(loss_ref), launches=counts,
                   padded_zero=padded_zero, peak_bytes=peak)
        if dtype == "bfloat16":
            loss_err, _ = _hold(torch, "pipeline loss", loss.reshape(1), loss_ref.reshape(1),
                                dtype, BWD_FLOOR)
            worst = _worst_share(torch, grads, grads_ref)
            kept.update(executor=grads, lm=grads_ref)       # for the float32 reference
            ref_ms.append(_wall_ms(torch, reference))        # LM.loss against itself
            floor = _worst_share(torch, res.pop("ref")[1], grads_ref)
            ex_ms.append(_wall_ms(torch, pipeline))
            res.clear()
            ref_ms.append(_wall_ms(torch, reference))
            ex_ms.append(_wall_ms(torch, pipeline))
            res.clear()
            med_ex, med_ref = statistics.median(ex_ms), statistics.median(ref_ms)
            log(card, f"pipeline gradients of {cfg.name} at full width and depth ({cfg.n_layers} "
                      f"layers, bf16, wq/wk fan-in d_model) on the {planned['setting']} plan's "
                      f"{spec.n_stages} stages {spec.layers_per_stage} (pad {spec.pad}), "
                      f"{spec.n_microbatches} microbatches of {plan.microbatch_size} x {PLAN_SEQ}, "
                      f"each stage remat'd: loss {float(loss):.6f} against LM.loss(remat='full')'s "
                      f"{float(loss_ref):.6f} (abs err {loss_err:.3e}); padded slots' gradients "
                      f"exactly zero; launches {counts}; gradients against LM.loss's: worst "
                      f"{worst[0]} at {worst[2]:.3g} x the backward's bound "
                      f"({TOL['bfloat16 grad']}), max abs err {worst[1]:.3e}, where a rerun of "
                      f"LM.loss reads {floor[2]:.3g} x ({floor[0]}): gated against float32 "
                      f"LM.loss below; executor loss + backward {med_ex:.1f} ms against LM.loss's "
                      f"{med_ref:.1f} ms (median of 3, host clock); peak memory "
                      f"{peak / 2**30:.2f} GiB over the first executor pass")
            rec.update(loss_abs_err=loss_err, layers_per_stage=list(spec.layers_per_stage),
                       pad=spec.pad, n_microbatches=spec.n_microbatches,
                       microbatch_size=plan.microbatch_size, seq=PLAN_SEQ,
                       worst_grad=dict(path=worst[0], max_abs_err=worst[1], bound_share=worst[2]),
                       rerun_worst_grad=dict(path=floor[0], max_abs_err=floor[1],
                                             bound_share=floor[2]),
                       executor_ms=ex_ms, plain_ms=ref_ms, executor_ms_median=med_ex,
                       plain_ms_median=med_ref)
            out.update(arch=planned["arch"], n_layers=cfg.n_layers, launches=counts)
        else:
            loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
            leaf, grad_err = _rel_to_max(torch, grads, grads_ref)
            log(card, f"pipeline gradients of {cfg.name} in float32 (TF32 off), the same plan and "
                      f"batch: loss {float(loss):.6f} against LM.loss's {float(loss_ref):.6f} (rel "
                      f"err {loss_err:.3e}), worst gradient {leaf} at {grad_err:.3e} of its leaf's "
                      f"max (tol {PIPE_GRAD_TOL}); padded slots' gradients exactly zero; launches "
                      f"{counts}; executor {ex_ms[0]:.1f} ms, LM.loss {ref_ms[0]:.1f} ms (one pass "
                      f"each); peak memory {peak / 2**30:.2f} GiB")
            if max(loss_err, grad_err) > PIPE_GRAD_TOL:
                raise AssertionError("the executor's float32 gradients disagree with LM.loss's")
            rec.update(loss_rel_err=loss_err, worst_grad=dict(path=leaf, rel_to_max=grad_err),
                       tol=PIPE_GRAD_TOL, executor_ms=ex_ms, plain_ms=ref_ms)
            bf = {who: _worst_share(torch, g, grads_ref) for who, g in kept.items()}
            rel = {who: _rel_to_max(torch, g, grads_ref) for who, g in kept.items()}
            kept.clear()
            limit = PIPE_BF16_RATIO * bf["lm"][2]
            log(card, f"bf16 gradients of {cfg.name} on that plan against LM.loss in float32 (the "
                      f"same seed, weights in float32): executor worst {bf['executor'][0]} at "
                      f"{bf['executor'][2]:.3g} x the backward's bound ({TOL['bfloat16 grad']}), "
                      f"LM.loss's bf16 gradients worst {bf['lm'][0]} at {bf['lm'][2]:.3g} x; gate: "
                      f"the executor's at most {PIPE_BF16_RATIO} x LM.loss's, {limit:.3g} x; "
                      f"worst max abs err over the leaf's max: executor {rel['executor'][1]:.3e} "
                      f"({rel['executor'][0]}), LM.loss {rel['lm'][1]:.3e} ({rel['lm'][0]})")
            out["bfloat16"]["against_float32"] = dict(
                executor=dict(path=bf["executor"][0], max_abs_err=bf["executor"][1],
                              bound_share=bf["executor"][2], rel_to_max=rel["executor"][1]),
                lm_loss=dict(path=bf["lm"][0], max_abs_err=bf["lm"][1], bound_share=bf["lm"][2],
                             rel_to_max=rel["lm"][1]),
                ratio_limit=PIPE_BF16_RATIO, share_limit=limit)
            if bf["executor"][2] > limit:
                raise AssertionError(f"the executor's bf16 gradients use {bf['executor'][2]:.3g} x "
                                     f"the backward's bound against float32 LM.loss, over "
                                     f"{PIPE_BF16_RATIO} x bf16 LM.loss's {bf['lm'][2]:.3g} x")
            if keep is not None:
                keep.update(loss=float(loss), grads={k: g.cpu() for k, g in grads.items()},
                            lm_grads={k: g.cpu() for k, g in grads_ref.items()},
                            bf16_limit=limit)
        out[dtype] = rec
        del params, tree, grads_ref, model, ex, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_pipeline_small(torch, card: str, planned: dict) -> dict:
    """A small float32 h2o-family model through the gradients plan's four
    stages, card against CPU: loss within 1e-4 relative and every gradient
    within 1e-4 of its leaf's largest magnitude (TF32 off), launches exact."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DoraPipelineExecutor

    cfg = dataclasses.replace(reduced_config("h2o_danube_1_8b"), **PIPE_SMALL)
    plan = planned["plan"]
    ex = DoraPipelineExecutor(plan, cfg.n_layers,
                              lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train"))
    spec = ex.spec
    B, S, tol = spec.n_microbatches * plan.microbatch_size, PIPE_SMALL_SEQ, 1e-4
    params = fan_in_qk(cfg, build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1)))
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_c, grads_c, zero_c = pipeline_grads(torch, build_model(cfg, device="cpu"), ex,
                                             pipeline_tree(ex, params), batch, S)
    tree_g, batch_g = pipeline_tree(ex, _to(params, DEVICE)), _to(batch, DEVICE)
    kernels.reset_launches()
    loss_g, grads_g, zero_g = pipeline_grads(torch, build_model(cfg, device=DEVICE), ex, tree_g,
                                             batch_g, S)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: 0 for k in kernels.KERNELS}
    want.update(flash_attention=2 * cfg.n_layers * spec.n_microbatches,
                flash_attention_bwd=cfg.n_layers * spec.n_microbatches)
    if counts != want:
        raise AssertionError(f"small pipeline launched {counts}, expected {want}")
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_err = max(float((grads_g[k].cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
                   for k, c in grads_c.items())
    _, grads_n, _ = pipeline_grads(torch, build_model(cfg, device="cpu"), ex,
                                   pipeline_tree(ex, _nudged(torch, params)), batch, S)
    cond = max(float((grads_n[k] - c).abs().max() / c.abs().max().clamp(min=1e-30))
               for k, c in grads_c.items())
    log(card, f"small f32 {cfg.name} ({cfg.n_layers} layers, {PIPE_SMALL}, wq/wk fan-in d_model, "
              f"S={S}) through the {planned['setting']} plan's stages {spec.layers_per_stage}, "
              f"{spec.n_microbatches} microbatches of {plan.microbatch_size}, card vs CPU: loss "
              f"rel err {loss_err:.3e}, worst gradient {grad_err:.3e} of its leaf's max (tol "
              f"{tol}); a 1e-7 change of the embedding moves the CPU's gradients by up to "
              f"{cond:.3e}; padded slots' gradients zero on both: {zero_c and zero_g}; launches "
              f"{counts}")
    if max(loss_err, grad_err) > tol or not (zero_c and zero_g):
        raise AssertionError("the card's pipeline disagrees with the CPU's")
    return dict(overrides=PIPE_SMALL, seq=S, layers_per_stage=list(spec.layers_per_stage),
                loss_rel_err=loss_err, grad_rel_err=grad_err, conditioning=cond, tol=tol,
                launches=counts)


# -- phase 6, one rank a stage -------------------------------------------------------------
RANKS_TIMEOUT = 600      # seconds for one run_ranks call; the group's own ops time out too


def _rank_executor(torch, plan, cfg):
    """The plan's ``DistributedPipelineExecutor`` over cfg's dense blocks,
    timing each stage call (forward; recompute and backward) by CUDA events
    on the card, the host clock on the CPU, and counting the bytes this rank
    sends."""
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DistributedPipelineExecutor

    class Timed(DistributedPipelineExecutor):
        def reset_stats(self):
            self.calls, self.sent = {"forward": [], "backward": []}, 0

        def _timed(self, kind, on_card, fn, *args):
            if on_card:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                y = fn(*args)
                b.record()
            else:
                a = time.perf_counter()
                y = fn(*args)
                b = time.perf_counter()
            self.calls[kind].append((a, b))
            return y

        def _stage_fn(self, x, layers, kept=None):
            return self._timed("forward", x.is_cuda, super()._stage_fn, x, layers, kept)

        def _stage_grad(self, kept, layers, g):
            return self._timed("backward", g.is_cuda, super()._stage_grad, kept, layers, g)

        def _send(self, t, dst):
            self.sent += t.numel() * t.element_size()
            super()._send(t, dst)

        def stats(self):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            return {k: sum(a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3
                           for a, b in v) for k, v in self.calls.items()}, self.sent

    ex = Timed(plan, cfg.n_layers, lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train"))
    ex.reset_stats()
    return ex


def _rank_params(torch, cfg, spec, rank: int, world: int, top_keys, device):
    """This rank's (pad, ...) block of the model's stack and its
    ``top_keys`` leaves, drawn from the seed the in-process parts use. The
    ranks draw the full model in turns, so one full copy at a time is on
    the card."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.runtime.pipeline import stage_block

    block = top = None
    for turn in range(world):
        if turn == rank:
            params = fan_in_qk(cfg, build_model(cfg, device=device).init(
                torch.Generator(device=device).manual_seed(0)))
            block = stage_block(params["stack"]["u0"], spec, rank)
            top = {k: params[k] for k in top_keys}
            del params
            gc.collect()
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    return block, top


def _rank_run(torch, device, fn):
    """(fn(), host-clock ms) between barriers, the card synchronised at
    both ends: the wall time until the last rank is done."""
    import torch.distributed as dist

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    sync()
    dist.barrier()
    return out, (time.perf_counter() - t0) * 1e3


def _rank_start(torch, device):
    """Reset the launch counters and the peak-memory reading."""
    from repro_torch import kernels

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()


def _rank_record(torch, device, ex, rank: int) -> dict:
    from repro_torch import kernels

    stage_ms, sent = ex.stats()
    return dict(rank=rank, layers=ex.spec.layers_per_stage[rank], stage_ms=stage_ms,
                sent_bytes=sent, launches=kernels.launch_counts(),
                peak_bytes=torch.cuda.max_memory_allocated() if device.type == "cuda" else 0)


def ranks_forward(rank: int, world: int, cfg, plan, seq: int, devices) -> dict:
    """One rank of the forward plan (run by ``run_ranks``): its stage of
    the model at full width and depth, the checked forward, then three
    timed ones. Rank 0 returns the output it got back from the last rank;
    every rank a checksum of its copy."""
    import torch

    begin = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(devices[rank])
    ex = _rank_executor(torch, plan, cfg)
    M, mb = ex.spec.n_microbatches, plan.microbatch_size
    block, top = _rank_params(torch, cfg, ex.spec, rank, world,
                              ("embed",) if rank == 0 else (), device)
    toks = torch.randint(0, cfg.vocab_size, (M * mb, seq), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        x = (top["embed"][toks].view(M, mb, seq, cfg.d_model) if rank == 0 else
             torch.empty((M, mb, seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                         device=device))
    del top
    _rank_start(torch, device)
    ready = time.time()
    out, wall = _rank_run(torch, device, lambda: ex.forward(block, x))
    rec = _rank_record(torch, device, ex, rank)
    rec.update(checksum=int(out.view(torch.int16).long().sum()) if out.dtype == torch.bfloat16
               else float(out.double().sum()), out=out if rank == 0 else None, checked_ms=wall,
               wall_ms=[_rank_run(torch, device, lambda: ex.forward(block, x))[1]
                        for _ in range(3)])
    rec["clock"] = dict(begin=begin, ready=ready, done=time.time())
    return rec


def ranks_grads(rank: int, world: int, cfg0, plan, seq: int, devices) -> dict:
    """One rank of the gradients plan (run by ``run_ranks``), in bf16 and
    then in float32: embed (rank 0), its stage, the final norm, head and
    NLL (last rank), by ``loss_and_grads``; the checked pass, in bf16 two
    more timed ones. Returns the loss, this rank's gradients (the block's
    under ``/stack/u0``, (pad, ...)) and its stage records."""
    import torch
    from repro_torch.models import build_model

    begin = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(devices[rank])
    top_keys = (("embed",) if rank == 0 else ()) + (("ln_f", "unembed") if rank == world - 1
                                                     else ())
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg0, dtype=dtype)
        ex = _rank_executor(torch, plan, cfg)
        M, mb = ex.spec.n_microbatches, plan.microbatch_size
        B, d = M * mb, cfg.d_model
        block, top = _rank_params(torch, cfg, ex.spec, rank, world, top_keys, device)
        p = {k: v.detach().requires_grad_(True) for k, v in top.items()}
        del top
        model = build_model(cfg, device=device)
        toks = torch.randint(0, cfg.vocab_size, (B, seq + 1), device=device, dtype=torch.int32,
                             generator=torch.Generator(device=device).manual_seed(2))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        def run():
            for v in p.values():
                v.grad = None
            if rank == 0:
                xe = p["embed"][batch["tokens"].long()].view(M, mb, seq, d)
                x = xe.detach()
            else:
                x = torch.empty((M, mb, seq, d), dtype=getattr(torch, cfg.dtype), device=device)
            loss, g_block, g_x = ex.loss_and_grads(
                block, x, lambda o: model.loss_from_hidden(p, o.reshape(B, seq, d), batch))
            if rank == 0:
                xe.backward(g_x)
            return loss, g_block
        _rank_start(torch, device)
        ready = time.time()
        (loss, g_block), wall = _rank_run(torch, device, run)
        rec = _rank_record(torch, device, ex, rank)
        grads = {"/stack/u0" + k: g for k, g in _named(g_block)}
        grads.update({"/" + k: v.grad for k, v in p.items()})
        checked = time.time()
        rec.update(loss=float(loss), grads={k: g.cpu() for k, g in grads.items()},
                   checked_ms=wall, wall_ms=[wall])
        del g_block, grads
        copied = time.time()
        if dtype == "bfloat16":
            rec["wall_ms"] += [_rank_run(torch, device, run)[1] for _ in range(2)]
        rec["clock"] = dict(begin=begin, ready=ready, checked=checked, copied=copied,
                            done=time.time())
        begin = rec["clock"]["done"]
        out[dtype] = rec
        del block, p, model, ex
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _sum_launches(per_rank) -> Dict[str, int]:
    return {k: sum(r["launches"][k] for r in per_rank) for k in per_rank[0]["launches"]}


def _rank_lines(card: str, what: str, per_rank) -> list:
    """One printed line a rank; the records without tensors."""
    rows = []
    for r in per_rank:
        log(card, f"{what}, rank {r['rank']} ({r['layers']} layers): stage calls "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in r["stage_ms"].items() if v)
                  + f" (CUDA events around each call, the checked pass); passes "
                  f"{r['checked_ms']:.1f} ms (checked), "
                  + ", ".join(f"{t:.1f}" for t in r["wall_ms"]) + " ms (host clock between "
                  f"barriers; clock {', '.join(f'{k} {v - r['clock']['begin']:.1f} s' for k, v in r['clock'].items() if k != 'begin')}); sent "
                  f"{r['sent_bytes'] / 1e6:.1f} MB to its neighbours; peak memory "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB (this rank's "
                  f"torch.cuda.max_memory_allocated over the checked pass)")
        rows.append({k: v for k, v in r.items() if k not in ("out", "grads")})
    return rows


def _assemble(torch, per_rank, spec):
    """The ranks' gradients as ``pipeline_grads`` gives them: each stack
    leaf's (pad, ...) blocks stacked, checked for zero padded slots and
    unpacked to (L, ...); the other leaves from the rank that has them.
    Returns (grads, whether every padded slot is exactly zero)."""
    out, zero = {}, True
    for key in per_rank[0]["grads"]:
        if key.startswith("/stack/"):
            blocks = [r["grads"][key] for r in per_rank]
            zero &= all(bool((b[n:] == 0).all()) for b, n in zip(blocks, spec.layers_per_stage))
            out[key] = torch.cat([b[:n] for b, n in zip(blocks, spec.layers_per_stage)])
    for r in per_rank:
        out.update({k: g for k, g in r["grads"].items() if not k.startswith("/stack/")})
    return out, zero


def _speedup(card: str, what: str, in_process_ms: float, ranks_ms: float, S: int, M: int):
    """Print the ranks' speedup over the in-process executor beside the
    GPipe ideal S M / (M + S - 1); recorded, not gated."""
    ideal = S * M / (M + S - 1)
    log(card, f"pipeline ranks {what}: speedup over the in-process executor "
              f"{in_process_ms / ranks_ms:.3f} x, GPipe ideal S M / (M + S - 1) = {ideal:.3f} x, "
              f"ratio {in_process_ms / ranks_ms / ideal:.3f} (not gated)")


def _on_device(torch, tree: dict) -> dict:
    return {k: v.to(DEVICE) for k, v in tree.items()}


def phase_pipeline_ranks(torch, card: str, planned: dict, done: dict, kept: dict,
                         backend: str = "gloo", devices=None) -> dict:
    """Phase 6's two plans through ``DistributedPipelineExecutor``, one
    rank a stage (``run_ranks``; on one card every rank on cuda:0 over
    gloo, which NCCL refuses), against the in-process executor's runs:
    ``done`` holds their records, ``kept`` their outputs and float32
    gradients on the host. Gates: the forward bitwise equal (else within
    the bf16 bound), float32 gradients within ``PIPE_GRAD_TOL`` of each
    leaf's max, the bf16 gradients' share of the bound within the
    in-process gate's limit, padded slots exactly zero, and the launches
    summed over the ranks equal to the in-process counts."""
    from repro_torch.runtime.ranks import run_ranks

    out = {}
    for what, fn in (("forward", ranks_forward), ("gradients", ranks_grads)):
        p = planned[what]
        spec, S = p["spec"], p["spec"].n_stages
        devs = list(devices[:S]) if devices else [DEVICE + ":0" if DEVICE == "cuda" else DEVICE] * S
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(card, f"pipeline ranks {what}: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free on "
                  f"cuda:0 before the ranks start (this process holds "
                  f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved)")
        t0, w0 = time.perf_counter(), time.time()
        res = run_ranks(fn, S, (p["cfg"], p["plan"], PLAN_SEQ, devs), backend=backend,
                        timeout=RANKS_TIMEOUT, devices=devs)
        run_s = time.perf_counter() - t0
        clocks = [r["clock"] for r in res] if what == "forward" else \
            [r[dt]["clock"] for dt in ("bfloat16", "float32") for r in res]
        log(card, f"pipeline ranks {what}: run_ranks took {run_s:.1f} s (host clock): the "
                  f"ranks up after {max(c['begin'] for c in clocks[:S]) - w0:.1f} s; the "
                  f"model draws and passes "
                  + ", ".join(f"{max(c['ready'] for c in clocks[i:i + S]) - max(c['begin'] for c in clocks[i:i + S]):.1f} s and "
                              f"{max(c['done'] for c in clocks[i:i + S]) - max(c['ready'] for c in clocks[i:i + S]):.1f} s"
                              for i in range(0, len(clocks), S))
                  + f"; the results back {w0 + run_s - max(c['done'] for c in clocks):.1f} s "
                  f"after the last rank's end")
        where = (f"{p['cfg'].name}'s {S} stages {list(spec.layers_per_stage)} on {S} {backend} "
                 f"ranks ({', '.join(devs)})")
        if what == "forward":
            counts, want = _sum_launches(res), done["forward"]["launches"]
            got, ref = res[0]["out"], kept["forward"]["out"]
            bitwise = bool(torch.equal(got, ref))
            err, share = _hold(torch, "the ranks' forward against the in-process executor's",
                               got.to(DEVICE), ref.to(DEVICE), "bfloat16")
            sums = {r["checksum"] for r in res}
            med, med_in = statistics.median(res[0]["wall_ms"]), done["forward"]["executor_ms_median"]
            rows = _rank_lines(card, f"pipeline ranks forward of {p['cfg'].name}", res)
            _speedup(card, "forward", med_in, med, S, spec.n_microbatches)
            log(card, f"pipeline ranks forward of {where}, {spec.n_microbatches} microbatches of "
                      f"{p['plan'].microbatch_size} x {PLAN_SEQ}: against the in-process "
                      f"executor {'bitwise equal' if bitwise else 'not bitwise equal'} (max abs "
                      f"err {err:.3e}, {share:.3g} of the bound), every rank's copy the same: "
                      f"{len(sums) == 1}; launches summed over the ranks {counts} (in-process "
                      f"{want}); wall {med:.1f} ms against the in-process executor's "
                      f"{med_in:.1f} ms (median of 3 each, host clock between barriers; the ranks "
                      f"share the card: {'no speedup expected, not gated' if not devices else 'one card a rank'}); "
                      f"the run took {run_s:.1f} s with the processes' start")
            if counts != want:
                raise AssertionError(f"the ranks' forward launched {counts}, in-process {want}")
            if len(sums) != 1:
                raise AssertionError(f"the ranks' copies of the output differ: {sums}")
            out[what] = dict(arch=p["arch"], backend=backend, devices=devs, bitwise=bitwise,
                             max_abs_err=err, bound_share=share, launches=counts, ranks=rows,
                             wall_ms=res[0]["wall_ms"], wall_ms_median=med,
                             in_process_ms_median=med_in, run_s=run_s)
            continue
        rec = {"arch": p["arch"], "backend": backend, "devices": devs, "run_s": run_s}
        for dtype in ("bfloat16", "float32"):
            per = [r[dtype] for r in res]
            counts, want = _sum_launches(per), done["gradients"][dtype]["launches"]
            grads, zero = _assemble(torch, per, spec)
            losses = {r["loss"] for r in per}
            loss = per[-1]["loss"]
            rows = _rank_lines(card, f"pipeline ranks gradients of {p['cfg'].name} ({dtype})", per)
            if counts != want:
                raise AssertionError(f"the ranks' gradients ({dtype}) launched {counts}, "
                                     f"in-process {want}")
            if not zero or len(losses) != 1:
                raise AssertionError(f"ranks' gradients ({dtype}): padded slots zero {zero}, "
                                     f"losses {losses}")
            if sorted(grads) != sorted(kept["gradients"]["grads"]):
                raise AssertionError(f"gradient leaves {sorted(grads)}")
            if dtype == "bfloat16":
                ref_loss = done["gradients"]["bfloat16"]["loss"]
                loss_err, _ = _hold(torch, "the ranks' bf16 loss",
                                    torch.tensor([loss], device=DEVICE),
                                    torch.tensor([ref_loss], device=DEVICE), dtype, BWD_FLOOR)
                worst = _worst_share(torch, _on_device(torch, grads),
                                     _on_device(torch, kept["gradients"]["lm_grads"]))
                limit = kept["gradients"]["bf16_limit"]
                med = statistics.median(per[0]["wall_ms"])
                med_in = done["gradients"]["bfloat16"]["executor_ms_median"]
                _speedup(card, "gradients (bf16)", med_in, med, S, spec.n_microbatches)
                log(card, f"pipeline ranks gradients of {where} (bf16), "
                          f"{spec.n_microbatches} microbatches of {p['plan'].microbatch_size} x "
                          f"{PLAN_SEQ}: loss {loss:.6f} against the in-process executor's "
                          f"{ref_loss:.6f} (abs err {loss_err:.3e}); padded slots' gradients "
                          f"exactly zero; gradients against float32 LM.loss: worst {worst[0]} at "
                          f"{worst[2]:.3g} x the backward's bound (gate {limit:.3g} x, the "
                          f"in-process gate's limit); launches summed over the ranks {counts}; "
                          f"wall {med:.1f} ms against the in-process executor's {med_in:.1f} ms "
                          f"(median of 3 each, host clock between barriers)")
                if worst[2] > limit:
                    raise AssertionError(f"the ranks' bf16 gradients use {worst[2]:.3g} x the "
                                         f"backward's bound, over {limit:.3g} x")
                rec[dtype] = dict(loss=loss, loss_abs_err=loss_err, launches=counts, ranks=rows,
                                  worst_grad=dict(path=worst[0], max_abs_err=worst[1],
                                                  bound_share=worst[2]), share_limit=limit,
                                  wall_ms=per[0]["wall_ms"], wall_ms_median=med,
                                  in_process_ms_median=med_in)
            else:
                ref_loss = kept["gradients"]["loss"]
                loss_err = abs(loss - ref_loss) / abs(ref_loss)
                leaf, grad_err = _rel_to_max(torch, _on_device(torch, grads),
                                             _on_device(torch, kept["gradients"]["grads"]))
                log(card, f"pipeline ranks gradients of {where} in float32 (TF32 off): loss "
                          f"{loss:.6f} against the in-process executor's {ref_loss:.6f} (rel err "
                          f"{loss_err:.3e}), worst gradient {leaf} at {grad_err:.3e} of its "
                          f"leaf's max (tol {PIPE_GRAD_TOL}); padded slots' gradients exactly "
                          f"zero; launches summed over the ranks {counts}; wall "
                          f"{per[0]['wall_ms'][0]:.1f} ms against the in-process executor's "
                          f"{done['gradients']['float32']['executor_ms'][0]:.1f} ms (one pass "
                          f"each)")
                if max(loss_err, grad_err) > PIPE_GRAD_TOL:
                    raise AssertionError("the ranks' float32 gradients disagree with the "
                                         "in-process executor's")
                rec[dtype] = dict(loss=loss, loss_rel_err=loss_err, launches=counts, ranks=rows,
                                  worst_grad=dict(path=leaf, rel_to_max=grad_err),
                                  tol=PIPE_GRAD_TOL, wall_ms=per[0]["wall_ms"],
                                  in_process_ms=done["gradients"]["float32"]["executor_ms"])
            del grads
        rec["launches"] = rec["bfloat16"]["launches"]
        out[what] = rec
        del res
    return out


def phase_plan_launcher(torch, card: str, args=LAUNCHER_ARGS) -> dict:
    """The serve launcher, the user's entry point, planning and serving on
    the card with ``--dynamics``; its launches checked exactly."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(LAUNCHER_ARCH)
    kernels.reset_launches()
    out = serve.main(args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: 0 for k in kernels.KERNELS}
    want.update(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * LAUNCHER_GEN)
    if counts != want:
        raise AssertionError(f"the planning launcher launched {counts}, expected {want}")
    if out["dynamics"] is None or not out["plan"].n_stages:
        raise AssertionError("the launcher returned no plan or no dynamics reaction")
    if not all(map(math.isfinite, (out["prefill_ms"], out["p50_ms"], out["p99_ms"]))):
        raise AssertionError(f"the launcher's times are not finite: {out}")
    dyn = out["dynamics"]
    log(card, f"serve launcher {' '.join(args)}: plan {out['plan_summary']} (planning "
              f"{out['planning_s'] * 1e3:.1f} ms of the host CPU); prefill {out['prefill_ms']:.1f} "
              f"ms, decode p50 {out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms (host clock); "
              f"adapter action {dyn['action']}, plan latency {out['plan'].latency * 1e3:.0f} -> "
              f"{dyn['plan'].latency * 1e3:.0f} ms (the planner's model of the edge fleet, not "
              f"this card); launches {counts}")
    return dict(arch=LAUNCHER_ARCH, args=args, plan=out["plan_summary"],
                planning_s=out["planning_s"], prefill_ms=out["prefill_ms"], p50_ms=out["p50_ms"], p99_ms=out["p99_ms"],
                action=dyn["action"], plan_latency_s=out["plan"].latency,
                plan_latency_after_s=dyn["plan"].latency, launches=counts)


def phase_catalogue_replan(torch, card: str) -> dict:
    """The forward plan's model and workload on ``CATALOGUE`` through the
    facade (``dora.serve``, the control plane armed), each event of the
    scenario's timeline fed to ``on_dynamics``, then the plan the session
    holds run through the executor as ``phase_pipeline_forward`` runs
    phase 6's (bitwise against the plain order, launches exact)."""
    from repro_torch import dora
    from repro_torch.configs import get_config
    from repro_torch.core import QoESpec, Workload
    from repro_torch.models.registry import planning_graph
    from repro_torch.runtime.pipeline import PipelineSpec
    from repro_torch.scenarios import get_scenario

    arch, _, (gb, mb, training), (t_qoe, lam) = PLANS["forward"]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    session = dora.serve(CATALOGUE, graph=planning_graph(cfg, PLAN_SEQ),
                         qoe=QoESpec(t_qoe=t_qoe, lam=lam),
                         workload=Workload(global_batch=gb, microbatch_size=mb, training=training))
    wall = time.perf_counter() - t0
    first = session.current
    log(card, f"dora.serve({CATALOGUE!r}) of {cfg.name} (serve: batch {gb} of {mb}, t_qoe "
              f"{t_qoe} s, lambda {lam}, sequence {PLAN_SEQ}): {first.summary()}; planning "
              f"{wall * 1e3:.1f} ms of the host CPU with the graph")
    actions = []
    for label, ev in get_scenario(CATALOGUE).timeline:
        before = session.current.latency
        plan, action, react = session.on_dynamics(ev)
        actions.append(dict(label=label, action=action, react_s=react,
                            latency_before_s=before, latency_after_s=plan.latency,
                            plan=plan.summary()))
        log(card, f"control plane, {label!r} at t={ev.t:g} s: {action} in {react * 1e3:.1f} ms "
                  f"(host CPU); plan latency {before * 1e3:.1f} -> {plan.latency * 1e3:.1f} ms "
                  f"(the planner's model of the platoon); {plan.summary()}")
    if [a["action"] for a in actions] != ["replan"] * len(actions) or not actions:
        raise AssertionError(f"the control plane's actions {[a['action'] for a in actions]}, "
                             f"not a replan for each timeline event as in the JAX package")
    plan = session.current
    spec = PipelineSpec.from_plan(plan, cfg.n_layers)
    if plan.n_stages < 2 or plan.microbatch_size != mb:
        raise AssertionError(f"the replanned plan {plan.summary()} is not the >= 2 stages of "
                             f"microbatch {mb} at which phase 2 holds the kernels")
    log(card, f"replanned plan executed: {plan.summary()}; {spec}")
    fwd = phase_pipeline_forward(torch, card, dict(arch=arch, setting=CATALOGUE, cfg=cfg,
                                                   plan=plan, spec=spec))
    return dict(arch=arch, setting=CATALOGUE, plan_before=first.summary(), actions=actions,
                plan=plan.summary(), layers_per_stage=list(spec.layers_per_stage),
                planning_wall_s=wall, forward=fwd, launches=fwd["launches"])


def phase_catalogue_host(card: str) -> dict:
    """Host code of the planning stack on the card machine, which has no
    jax: the scenario CLI (``python -m repro_torch.scenarios``, a process
    of its own) and ``dora.compare`` in this one."""
    from repro_torch import dora

    cmd = [sys.executable, "-m", "repro_torch.scenarios", "--run", CATALOGUE, "--simulate",
           "--requests"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    m = re.search(r"latency p50/p95/p99: ([\d.]+) ms / ([\d.]+) ms / ([\d.]+) ms", res.stdout)
    if not m or not all(math.isfinite(float(x)) for x in m.groups()):
        raise AssertionError(f"no finite p50/p95/p99 in the CLI's output:\n{res.stdout}")
    p50, p95, p99 = map(float, m.groups())
    log(card, f"python {' '.join(cmd[1:])} ({cli_s:.1f} s, host): request run p50 {p50:g} ms, "
              f"p95 {p95:g} ms, p99 {p99:g} ms; "
              + "; ".join(line.strip() for line in res.stdout.splitlines()
                          if line.strip().startswith(("best:", "QoE target", "SLO attainment"))))
    t0 = time.perf_counter()
    rep = dora.compare(CATALOGUE, strategies=CATALOGUE_STRATEGIES)
    compare_s = time.perf_counter() - t0
    for line in rep.summary().splitlines():
        log(card, f"compare: {line}")
    rows = rep.to_dict()["strategies"]
    bad = [n for n, r in rows.items() if not r["ok"] or not math.isfinite(r["latency_s"])]
    if bad or set(rows) != set(CATALOGUE_STRATEGIES):
        raise AssertionError(f"compare on {CATALOGUE}: strategies without a finite plan {bad}")
    if not rep.meets_qoe("dora"):
        raise AssertionError(f"dora misses {CATALOGUE}'s QoE, which it meets in the JAX package")
    jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if jax:
        raise AssertionError(f"the planning stack imported {jax}")
    return dict(cli=" ".join(cmd[1:]), cli_s=cli_s, p50_ms=p50, p95_ms=p95, p99_ms=p99,
                compare_s=compare_s, compare=rows)


def phase_dora(torch, card: str) -> dict:
    """Phase 6: plan, then run the plans' pipeline stages and the planning
    launcher on the card, then the catalogue part; each part frees what it
    made."""
    planned = {what: phase_plan(torch, card, what) for what in PLANS}
    out = {"plans": {w: {k: v for k, v in p.items() if k not in ("cfg", "plan", "spec")}
                     for w, p in planned.items()}}
    kept = {"forward": {}, "gradients": {}}      # the in-process runs' results, for the ranks
    for name, fn in (("forward", lambda: phase_pipeline_forward(torch, card, planned["forward"],
                                                                kept["forward"])),
                     ("gradients",
                      lambda: phase_pipeline_grads(torch, card, planned["gradients"],
                                                   kept["gradients"])),
                     ("ranks", lambda: phase_pipeline_ranks(torch, card, planned, out, kept)),
                     ("small", lambda: phase_pipeline_small(torch, card, planned["gradients"])),
                     ("launcher", lambda: phase_plan_launcher(torch, card)),
                     ("catalogue_launcher",
                      lambda: phase_plan_launcher(torch, card, CATALOGUE_LAUNCHER_ARGS)),
                     ("catalogue_replan", lambda: phase_catalogue_replan(torch, card)),
                     ("catalogue_host", lambda: phase_catalogue_host(card))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        log(card, f"phase 6 part {name} took {out[name]['seconds']:.1f} s (host clock)")
        if name == "ranks":
            kept.clear()
    return out


# ==============================================================================
# phase 7: calibration on the card
# ==============================================================================
CAL_DIR = os.path.join(REPO, "build", "calibration")
CAL_FLEET = 4          # logical devices, all on the one card (the executor's stages)
CAL_SETTING = "traffic_monitor"
CAL_SCENARIO = "smart_home_2"      # dora.calibrate(scenario): the factors as a global correction


def calibration_launches() -> Dict[str, int]:
    """The launches ``calibrate_host`` makes, from ``measure_host``'s settings:
    ``kernel_rates`` times each kernel through ``time_callable``, 2 warm-up
    calls and 3 timed; each reduced step is called 2 + 5 times and launches
    once a layer: qwen3's decode step decode_attention (its train step, at
    sequence 32, stays below attn_chunk), mamba2's train step the SSD scan and
    its backward (its decode step runs the recurrence alone)."""
    from repro_torch.configs import reduced_config
    rate, step = 2 + 3, 2 + 5
    lq, lm = reduced_config("qwen3_32b").n_layers, reduced_config("mamba2_780m").n_layers
    return {"flash_attention": rate, "flash_attention_bwd": 0,
            "decode_attention": rate + step * lq, "ssd_scan": rate + step * lm,
            "ssd_scan_bwd": step * lm, "rglru_scan": rate, "rglru_scan_bwd": 0}


def phase_calibrate(torch, card: str) -> dict:
    """``repro_torch.calibrate`` on the card, as ``python -m
    repro_torch.calibrate`` runs it with the reference's defaults: the
    microbenchmarks and the ProfiledCosts artifact (``calibrate_host``, an
    in-memory cache), the fidelity suite over ``CASES`` then ``QUICK_CASES``
    (plan, price both ways, execute through the pipeline executor, compare),
    the regression gate against the committed ``calibration/h100_fidelity.json``
    (on a copy), and a Table 3 setting planned with the artifact. Both JSON
    records are written under build/calibration and printed on one line."""
    import shutil
    from repro_torch import dora, kernels
    from repro_torch.calibrate import fidelity, host, timing
    from repro_torch.calibrate.microbench import measure_host

    fleet = timing.Fleet("cuda", CAL_FLEET)
    os.makedirs(CAL_DIR, exist_ok=True)
    art, bench = os.path.join(CAL_DIR, "h100.json"), os.path.join(CAL_DIR, "h100_fidelity.json")
    if os.path.exists(bench):
        os.remove(bench)
    cache = timing.MeasurementCache(path=None, fleet=fleet)
    kernels.reset_launches()
    t0 = time.perf_counter()
    costs = dora.calibrate(quick=False, path=art, cache=cache)     # calibrate_host's defaults
    host_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    measure = measure_host(cache)            # every value from the cache now
    for k, v in measure.items():
        log(card, f"calibration measurement {k}: {v:.6g}")
    factor = next(iter(costs.compute_factor.values()))
    log(card, f"dora.calibrate ({timing.backend_key(fleet)}, {host_s:.1f} s): compute factor "
              f"{factor:.6g} on {len(costs.compute_factor)} logical devices (claimed "
              f"{costs.provenance['claimed_effective_flops']} FLOP/s, achieved "
              f"{costs.provenance['achieved_contended_flops']}), hostmem bandwidth factor "
              f"{costs.bandwidth_factor.get(host.HOSTMEM)}; step ratios (analytic / measured) "
              + ", ".join(f"{k.split('/', 1)[1]} {v}" for k, v in sorted(costs.provenance.items())
                          if k.startswith("step_ratio/")) + f"; launches {counts}")
    need = calibration_launches()
    if dict(counts) != need:
        raise AssertionError(f"calibration's launches {dict(counts)}, not the {need} that "
                             f"measure_host's repeats and the reduced configs' layers make")
    log(card, "calibration/h100.json: " + costs.to_json(indent=None))

    records = {}
    for label, cases in (("current", fidelity.CASES), ("quick", fidelity.QUICK_CASES)):
        t0 = time.perf_counter()
        rec = fidelity.run_fidelity(cases, quick=label == "quick", cache=cache)
        records[label] = rec
        for name, r in rec["cases"].items():
            log(card, f"fidelity {label} {name} ({r['mode']}, {r['n_stages']} stages, "
                      f"{r['layers']} layers {r['d_model']}x{r['d_ff']}, {r['microbatches']} "
                      f"microbatches, layout from the {r['layout']}): measured "
                      f"{r['measured_s'] * 1e3:.3f} ms, calibrated "
                      f"{r['calibrated']['predicted_s'] * 1e3:.3f} ms (error "
                      f"{r['calibrated']['rel_err']:.4f}), uncalibrated "
                      f"{r['uncalibrated']['predicted_s'] * 1e3:.3f} ms (error "
                      f"{r['uncalibrated']['rel_err']:.4f}), compute factor "
                      f"{r['compute_factor']:.6g}")
        log(card, f"fidelity {label} ({time.perf_counter() - t0:.1f} s): mean error calibrated "
                  f"{rec['mean_rel_err_calibrated']:.4f}, uncalibrated "
                  f"{rec['mean_rel_err_uncalibrated']:.4f}, gain {rec['calibration_gain']:.2f}x")
        if not rec["mean_rel_err_calibrated"] < rec["mean_rel_err_uncalibrated"]:
            raise AssertionError(f"calibration does not help on the card ({label})")
    fidelity.write_bench(records["current"], bench)
    fidelity.write_quick(records["quick"], bench)
    with open(bench, encoding="utf-8") as f:
        log(card, "calibration/h100_fidelity.json: " + json.dumps(json.load(f)))

    gate = None
    committed = os.path.join(REPO, "calibration", "h100_fidelity.json")
    if os.path.exists(committed):
        copy = os.path.join(CAL_DIR, "committed_fidelity.json")
        shutil.copyfile(committed, copy)
        gate = fidelity.check_regression(copy, fleet)
        log(card, f"check_regression against the committed calibration/h100_fidelity.json: "
                  f"{'OK' if gate == 0 else 'FAIL'}")
        if gate != 0:
            raise AssertionError("calibrated fidelity regressed against the committed record")
    else:
        log(card, "no committed calibration/h100_fidelity.json yet: no regression gate")

    # a Table 3 setting planned with the artifact; its devices are not host<i>,
    # so the factors fall back to the defaults there; the same setting's model and
    # workload over the measured fleet shows the calibrated prediction
    plans = {}
    for where, topo in (("Table 3 fleet", None),
                        ("measured fleet", host.host_topology(measure, CAL_FLEET))):
        for label, c in (("analytic", None), ("profiled", f"profiled:{art}")):
            planner, _, wl = dora.planner_for(CAL_SETTING, topology=topo, costs=c)
            best = planner.plan(wl).best
            plans[f"{where} {label}"] = dict(latency_s=best.latency, stages=best.n_stages)
        log(card, f"{CAL_SETTING} on the {where}: best plan's latency "
                  f"{plans[f'{where} analytic']['latency_s'] * 1e3:.3f} ms analytic, "
                  f"{plans[f'{where} profiled']['latency_s'] * 1e3:.3f} ms with costs="
                  f"'profiled:build/calibration/h100.json' "
                  f"({plans[f'{where} profiled']['stages']} stages)")
    counts = kernels.launch_counts()

    # the card's factors applied to a catalogue scenario from the same cache:
    # nothing is measured again
    misses = cache.misses
    scen = dora.calibrate(CAL_SCENARIO, quick=False, cache=cache)
    if cache.misses != misses or kernels.launch_counts() != counts:
        raise AssertionError(f"dora.calibrate({CAL_SCENARIO!r}) measured again ({cache.misses - misses} "
                             f"cache misses, launches {kernels.launch_counts()})")
    analytic, profiled = dora.plan(CAL_SCENARIO), dora.plan(CAL_SCENARIO, costs=scen)
    log(card, f"dora.calibrate({CAL_SCENARIO!r}) from the same cache ({cache.misses - misses} "
              f"misses): {scen.name}, default compute factor {scen.default_compute:.6g}, "
              f"bandwidth factor {scen.default_bandwidth:.6g}; {CAL_SCENARIO}'s best plan "
              f"{analytic.latency * 1e3:.3f} ms analytic, {profiled.latency * 1e3:.3f} ms with "
              f"those factors ({profiled.best.n_stages} stages)")
    plans[f"{CAL_SCENARIO} analytic"] = dict(latency_s=analytic.latency,
                                             stages=analytic.best.n_stages)
    plans[f"{CAL_SCENARIO} profiled"] = dict(latency_s=profiled.latency,
                                             stages=profiled.best.n_stages)
    return dict(measure=measure, costs=json.loads(costs.to_json()), fidelity=records,
                regression_gate=gate, plans=plans, launches=counts,
                scenario_costs=json.loads(scen.to_json()))


# -- phase 8: the mesh and the elastic controller ------------------------------------
MESH_ARCH = "h2o_danube_1_8b"
MESH_LAYERS = 8               # of 24: the script's time (phase 5 trains all 24)
MESH_BATCH, MESH_SEQ = 2, 8192
MESH_TIMEOUT = 900            # seconds for one run_ranks call
# bf16 on a (1, 1) mesh: the DTensor step is the plain step's arithmetic, so
# its loss must be bitwise and its grad norm (DTensor sums each leaf's squares
# as it reduces them) within this relative error
MESH_ONE_GNORM_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class MeshRun:
    """One training run under a (1, world) ("data", "model") mesh: the arch
    (full width; ``layers`` of its depth, None for all; ``reduced`` takes
    the smoke-scale config), ``overrides`` of its config, the dtype, batch x
    sequence, steps before the sharded checkpoint, the survivors the elastic
    controller regroups (``shrink_to``; equal to the world, it remeshes onto
    a fresh group of every rank), steps after the restore, and whether rank 0
    holds each step against the plain one-card step from the same state."""
    arch: str
    layers: Optional[int]
    dtype: str
    batch: int
    seq: int
    steps_before: int
    shrink_to: int
    steps_after: int
    ckpt_dir: str
    pid_dir: str
    compare: bool = True
    reduced: bool = False
    overrides: tuple = ()


def wait_gone(pid_dir: str, ranks, timeout: float = 120.0) -> bool:
    """Whether the processes of ``ranks`` (each writes its pid into
    ``pid_dir`` as it leaves) have all exited."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        paths = [os.path.join(pid_dir, f"{r}.pid") for r in ranks]
        pids = []
        for path in paths:
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                if text:
                    pids.append(int(text))
        if len(pids) == len(paths):
            alive = 0
            for pid in pids:
                try:
                    os.kill(pid, 0)
                    alive += 1
                except ProcessLookupError:
                    pass
            if not alive:
                return True
        time.sleep(0.05)
    return False


def gather(tree, keep: bool, to_cpu: bool = False):
    """A copy of every leaf's whole value (a collective per DTensor leaf,
    leaf by leaf, so a rank holds one gathered leaf at a time unless
    ``keep``); None leaves where not ``keep``."""
    def one(t):
        if hasattr(t, "full_tensor"):
            local, t = t.to_local(), t.full_tensor()
            if t.untyped_storage().data_ptr() == local.untyped_storage().data_ptr():
                t = t.clone()          # a replicated leaf's whole value is its local tensor
        else:
            t = t.detach().clone()
        return (t.cpu() if to_cpu else t) if keep else None
    if isinstance(tree, dict):
        return {k: gather(v, keep, to_cpu) for k, v in tree.items()}
    return one(tree)


def mesh_train_rank(rank: int, world: int, run: MeshRun) -> dict:
    """One rank of a ``MeshRun`` (started by ``run_ranks``): the model drawn
    from the seed on this rank's device and laid out on a (1, world) mesh by
    ``ShardingRules``, AdamW state alike, ``TokenPipeline`` placing each
    batch on the mesh, ``make_train_step`` (remat="full") for
    ``steps_before`` steps, a sharded async checkpoint, then the elastic
    controller: every rank is fed the same beats, the ranks from
    ``shrink_to`` on fall silent and exit, the survivors regroup (a group of
    generation 1), restore onto (1, shrink_to) and take ``steps_after``
    steps. Before each step rank 0 gathers the whole state and runs the
    plain step from it on its own device (when ``compare``); in bf16 on more
    than one rank it also takes the float32 model's gradients from that
    state (the weights cast), and after the step it holds the clipped
    gradients that the DTensor step and the plain step put into the first
    moments against them. Returns the numbers; the gates are the
    caller's."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.sharding import ShardingRules, train_state_specs
    from repro_torch.models.sharding_utils import distribute_tree
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm, tree_leaves, tree_map
    from repro_torch.runtime import ElasticController, ElasticState, ranks

    device = ranks.rank_device()          # the mesh's device type too (make_host_mesh)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    full = reduced_config(run.arch) if run.reduced else get_config(run.arch)
    cfg = dataclasses.replace(full, n_layers=run.layers or full.n_layers, dtype=run.dtype,
                              **dict(run.overrides))
    total = run.steps_before + run.steps_after
    model, train_step = make_train_step(cfg, peak_lr=3e-4, warmup=2, total=total,
                                        remat="full", device=device)
    # phase 6's rule for bf16 gradients at depth (bf16 is not bitwise against
    # itself there): held against the float32 model's, as the plain step's are
    ratio_rule = run.compare and cfg.dtype == "bfloat16" and world > 1
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=device) \
        if ratio_rule else None
    opt_cfg = AdamWConfig()               # make_train_step's
    per_step = {k: 0 for k in kernels.KERNELS}
    per_step.update(train_launches(cfg, run.seq))
    rec = dict(rank=rank, world=world, config=full.name, n_layers=cfg.n_layers,
               full_layers=full.n_layers, dtype=cfg.dtype, batch=run.batch, seq=run.seq,
               steps=[], generations=[0], worlds=[world], per_step_launches=per_step,
               launches={k: 0 for k in kernels.KERNELS}, branches={"local": 0, "replicate": 0})

    def data_for(mesh, skip: int):
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq,
                                        global_batch=run.batch, seed=0), device=device,
                             mesh=mesh)
        for _ in range(skip):
            next(data)
        return data

    def clipped(g: dict) -> dict:
        """The gradients ``g`` (path -> tensor, float32) clipped in place as
        AdamW clips them."""
        scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(global_norm(g), min=1e-9), max=1.0)
        return {k: t.mul_(scale) for k, t in g.items()}

    def from_moments(m_new, m_prev) -> dict:
        """The clipped gradient a step put into the first moments,
        (m_new - b1 m_prev) / (1 - b1), in place in ``m_new``."""
        prev = dict(_named(m_prev))
        return {k: t.sub_(prev[k], alpha=opt_cfg.b1).div_(1.0 - opt_cfg.b1)
                for k, t in _named(m_new)}

    def f32_grads(params, batch) -> dict:
        """The float32 model's clipped gradients at ``params`` (cast)."""
        leaves = [t.detach().float().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        loss, _ = model32.loss(tree_map(lambda _: next(it), params), batch, remat="full")
        grads = torch.autograd.grad(loss, leaves)
        del loss, leaves
        return clipped(dict(zip((k for k, _ in _named(params)), grads)))

    def plain_step(state, batch, i):
        """Rank 0: the plain one-card step from the gathered whole state."""
        snap = gather(state, rank == 0)
        plain_batch = {k: v.full_tensor() for k, v in batch.items()}
        if rank != 0:
            return None
        out = {}
        if ratio_rule:
            out["m_prev"] = tree_map(lambda t: t.clone(), snap["opt"]["m"])
            out["f32_grads"] = f32_grads(snap["params"], plain_batch)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        sync()
        t0 = time.perf_counter()
        p, o, m = train_step(snap["params"], snap["opt"], plain_batch, i)
        sync()
        out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   ms=(time.perf_counter() - t0) * 1e3)
        if cfg.dtype == "float32":
            out["state"] = {"params": p, "m": o["m"]}
        if ratio_rule:
            out["plain_grads"] = from_moments(o["m"], out["m_prev"])
        return out

    def held_bytes(tree) -> int:
        """Device bytes of the tensors in ``tree`` (rank 0's comparison
        state, held through the DTensor step and left out of its peak)."""
        if isinstance(tree, dict):
            return sum(held_bytes(v) for v in tree.values())
        if isinstance(tree, torch.Tensor) and tree.device.type == "cuda":
            return tree.numel() * tree.element_size()
        return 0

    def step(params, opt, data, i, mesh):
        batch = next(data)
        ref = plain_step({"params": params, "opt": opt}, batch, i) if run.compare else None
        gc.collect()
        held = held_bytes(ref)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        before, br = kernels.launch_counts(), dict(ops.dtensor_branch)
        sync()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            params, opt, m = train_step(params, opt, batch, i)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        for k in got:
            rec["launches"][k] += got[k]
        for k in br:
            rec["branches"][k] += ops.dtensor_branch[k] - br[k]
        r = dict(step=i, mesh=tuple(mesh.shape), loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), ms=ms, launches=got,
                 peak_bytes=torch.cuda.max_memory_allocated() - held if on_card else 0)
        if run.compare and cfg.dtype == "float32":  # the moments and parameters, whole
            st = gather({"params": params, "m": opt["m"]}, rank == 0)
            if rank == 0:
                # the first moments (0.1 x the clipped gradient) within a share of
                # each leaf's max; the parameters within the f32 tolerance
                # elementwise (Adam turns f32 noise on a tiny gradient into an
                # lr-sized move, which a share of a zero-initialised leaf's max
                # would magnify)
                m_err, p_share = {}, {}
                for (path, a), (_, b) in zip(_named(st), _named(ref.pop("state"))):
                    a, b = a.detach().float(), b.detach().float()
                    if path.startswith("/m/"):
                        m_err[path] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    else:
                        p_share[path] = bound_share(torch, a, b, "float32")[1]
                wm, wp = max(m_err, key=m_err.get), max(p_share, key=p_share.get)
                r["state_worst"] = dict(moment=wm, moment_rel_to_max=m_err[wm], param=wp,
                                        param_f32_share=p_share[wp])
            del st
        if ratio_rule:                      # phase 6's rule on the clipped gradients
            mesh_m = gather(opt["m"], rank == 0)
            if rank == 0:
                got = from_moments(mesh_m, ref.pop("m_prev"))
                f32, plain = ref.pop("f32_grads"), ref.pop("plain_grads")
                r["grad_shares"] = {who: _worst_share(torch, g, f32)
                                    for who, g in (("mesh", got), ("plain", plain))}
                del got, f32, plain
            del mesh_m
        if ref is not None:
            r["plain"] = ref
        rec["steps"].append(r)
        return params, opt

    mesh = make_host_mesh()
    params = fan_in_qk(cfg, model.init(torch.Generator(device=device).manual_seed(0)))
    params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    opt = adamw_init(params)
    data = data_for(mesh, 0)
    for i in range(run.steps_before):
        params, opt = step(params, opt, data, i, mesh)
    data.close()

    # the sharded checkpoint, and the state it holds (rank 0, on the host)
    state = {"params": params, "opt": opt}
    saved = gather(state, rank == 0, to_cpu=True)
    ckpt = Checkpointer(run.ckpt_dir, async_save=True)
    sync()
    t0 = time.perf_counter()
    ckpt.save(run.steps_before, state)
    ckpt.wait()
    rec["save_s"] = time.perf_counter() - t0
    rec["ckpt_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                            for d, _, files in os.walk(run.ckpt_dir) for f in files)
    shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)

    ctrl = ElasticController(
        make_mesh=lambda n: make_host_mesh(),
        spec_fn=lambda m, sh: train_state_specs(ShardingRules(cfg, m), sh), ckpt=ckpt,
        n_devices=world)
    for beat in (1.0, 2.0, 3.0, 4.0):
        for d in range(run.shrink_to):
            ctrl.coordinator.beat(d, beat)
    rec["failed"] = sorted(ctrl.coordinator.tick(5.0))
    t_verdict = time.perf_counter()
    if rec["failed"]:                    # nothing touches the old group again
        ranks.leave()
    del params, opt, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if rank >= run.shrink_to:            # fallen silent: exit
        with open(os.path.join(run.pid_dir, f"{rank}.pid"), "w") as f:
            f.write(str(os.getpid()))
        return rec
    rec["gone_before_regroup"] = wait_gone(run.pid_dir, range(run.shrink_to, world))
    t_gone = time.perf_counter()
    new = ctrl.remesh(ElasticState(mesh=mesh, step=run.steps_before, params=None,
                                   opt_state=None), shapes)
    sync()
    t_restored = time.perf_counter()
    rec["generations"].append(new.generation)
    rec["worlds"].append(dist.get_world_size())
    back = gather({"params": new.params, "opt": new.opt_state}, rank == 0, to_cpu=True)
    if rank == 0:
        rec["restored_bitwise"] = all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(tree_leaves(saved), tree_leaves(back)))
    del saved, back
    params, opt = new.params, new.opt_state
    data = data_for(new.mesh, run.steps_before)
    for i in range(run.steps_before, total):
        params, opt = step(params, opt, data, i, new.mesh)
    data.close()
    first = rec["steps"][run.steps_before]["ms"]
    rec["remesh"] = dict(wait_s=t_gone - t_verdict, regroup_restore_s=t_restored - t_gone,
                         first_step_s=first / 1e3,
                         total_s=t_restored - t_verdict + first / 1e3)
    del params, opt, new
    return rec


def mesh_phase(torch, card: str, run: MeshRun, world: int, devices, what: str,
               timeout: float = MESH_TIMEOUT) -> dict:
    """A ``MeshRun`` on ``world`` nccl ranks (one a card, ``devices``; gloo
    ranks on the CPU without ``devices``, for a rehearsal),
    gated: every step's loss and grad norm against the plain one-card
    step's (float32: within ``PIPE_GRAD_TOL`` relative, the first moments
    after each step within ``PIPE_GRAD_TOL`` of each leaf's max and the
    parameters within the float32 tolerance; bf16: within the bf16 bound
    ``_hold`` holds phase 6's loss to, and on a (1, 1) mesh the loss bitwise
    and the grad norm within ``MESH_ONE_GNORM_TOL`` relative; on more ranks
    the clipped gradients by phase 6's rule: against the float32 model's,
    the DTensor step's worst leaf may use at most ``PIPE_BF16_RATIO`` times
    the share of the backward's bound that the plain step's uses), the
    launches of the DTensor steps exact, the restore bit for bit, every
    survivor on the new group."""
    from repro_torch.runtime.ranks import run_ranks

    t0 = time.perf_counter()
    recs = run_ranks(mesh_train_rank, world, (run,), backend="nccl" if devices else "gloo",
                     timeout=timeout, devices=devices)
    wall = time.perf_counter() - t0
    r0 = recs[0]
    steps = run.steps_before + run.steps_after
    survivors = recs[:run.shrink_to]
    for r in recs:
        if r["failed"] != list(range(run.shrink_to, world)):
            raise AssertionError(f"rank {r['rank']} saw {r['failed']} fail")
    for r in survivors:
        if r["generations"] != [0, 1] or r["worlds"] != [world, run.shrink_to]:
            raise AssertionError(f"rank {r['rank']}: generations {r['generations']}, worlds "
                                 f"{r['worlds']}")
        if not r["gone_before_regroup"]:
            raise AssertionError(f"rank {r['rank']} regrouped before the failed ranks exited")
        if len(r["steps"]) != steps:
            raise AssertionError(f"rank {r['rank']} took {len(r['steps'])} steps")
        want = {k: v * steps for k, v in r["per_step_launches"].items()}
        if DEVICE == "cuda" and r["launches"] != want:
            raise AssertionError(f"rank {r['rank']}'s DTensor steps launched {r['launches']}, "
                                 f"expected {want}")
    if not r0["restored_bitwise"]:
        raise AssertionError("the state restored onto the new mesh differs from the saved one")
    rows = []
    for s in r0["steps"]:
        if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])):
            raise AssertionError(f"step {s['step']}: loss {s['loss']}, grad norm {s['grad_norm']}")
        p = s.get("plain")
        if p is None:
            continue
        got = torch.tensor([s["loss"], s["grad_norm"]], dtype=torch.float64)
        exp = torch.tensor([p["loss"], p["grad_norm"]], dtype=torch.float64)
        bitwise = bool(torch.equal(got, exp))
        if run.dtype == "float32":
            rel = float(((got - exp).abs() / exp.abs()).max())
            worst = s["state_worst"]
            if (rel > PIPE_GRAD_TOL or worst["moment_rel_to_max"] > PIPE_GRAD_TOL
                    or worst["param_f32_share"] > 1.0):
                raise AssertionError(f"float32 step {s['step']} on {s['mesh']}: loss/grad norm "
                                     f"rel err {rel:.3e}, worst state leaves {worst}")
            share = None
        else:
            rel = float(((got - exp).abs() / exp.abs()).max())
            _, share = _hold(torch, f"{what} step {s['step']} loss and grad norm",
                             got.reshape(1, 2).t(), exp.reshape(1, 2).t(), "bfloat16",
                             BWD_FLOOR)
            if s["mesh"] == (1, 1):
                gn_rel = abs(s["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
                if s["loss"] != p["loss"] or gn_rel > MESH_ONE_GNORM_TOL:
                    raise AssertionError(
                        f"{what} step {s['step']} on (1, 1): loss {s['loss']!r} against the plain "
                        f"step's {p['loss']!r} (must be bitwise), grad norm rel err {gn_rel:.3e} "
                        f"(tol {MESH_ONE_GNORM_TOL})")
            gs = s.get("grad_shares")
            if gs is not None:
                limit = PIPE_BF16_RATIO * gs["plain"][2]
                log(card, f"{what} step {s['step']} on a {s['mesh']} mesh: clipped bf16 "
                          f"gradients against the float32 model's: DTensor step worst "
                          f"{gs['mesh'][0]} at {gs['mesh'][2]:.3g} x the backward's bound "
                          f"({TOL['bfloat16 grad']}), plain step worst {gs['plain'][0]} at "
                          f"{gs['plain'][2]:.3g} x; gate {PIPE_BF16_RATIO} x the plain's, "
                          f"{limit:.3g} x")
                if gs["mesh"][2] > limit:
                    raise AssertionError(
                        f"{what} step {s['step']}: the DTensor step's bf16 gradients use "
                        f"{gs['mesh'][2]:.3g} x the backward's bound against float32, over "
                        f"{PIPE_BF16_RATIO} x the plain step's {gs['plain'][2]:.3g} x")
        rows.append(dict(step=s["step"], mesh=s["mesh"], loss=s["loss"], plain_loss=p["loss"],
                         grad_norm=s["grad_norm"], plain_grad_norm=p["grad_norm"],
                         bitwise=bitwise, rel_err=rel, bound_share=share,
                         state_worst=s.get("state_worst"), grad_shares=s.get("grad_shares"),
                         ms=s["ms"], plain_ms=p["ms"]))
        log(card, f"{what} step {s['step']} on a {s['mesh']} mesh: loss {s['loss']:.6f} (plain "
                  f"one-card step {p['loss']:.6f}), grad norm {s['grad_norm']:.6f} (plain "
                  f"{p['grad_norm']:.6f}), {'bitwise' if bitwise else f'rel err {rel:.3e}'}"
                  + (f", {share:.3g} x the bf16 bound" if share is not None else "")
                  + (f", first moments' worst {s['state_worst']['moment']} at "
                     f"{s['state_worst']['moment_rel_to_max']:.3e} of its max, parameters' "
                     f"worst {s['state_worst']['param']} at "
                     f"{s['state_worst']['param_f32_share']:.3g} x the f32 tolerance ({TOL['float32']})"
                     if s.get("state_worst") else "")
                  + f"; {s['ms']:.1f} ms (plain {p['ms']:.1f} ms); launches {s['launches']}")
    by_mesh: Dict[str, list] = {}
    for s in r0["steps"]:
        by_mesh.setdefault(str(s["mesh"]), []).append(s["ms"])
    peaks = {r["rank"]: max(s["peak_bytes"] for s in r["steps"]) for r in survivors}
    for r in recs[run.shrink_to:]:
        peaks[r["rank"]] = max(s["peak_bytes"] for s in r["steps"])
    rem = r0["remesh"]
    log(card, f"{what}: {r0['config']} ({r0['n_layers']} of {r0['full_layers']} layers, "
              f"{r0['dtype']}, batch {run.batch} x {run.seq}, remat='full') on {world} "
              f"{'nccl' if devices else 'gloo'} rank(s), (1, {world}) -> (1, {run.shrink_to}); "
              f"step ms by mesh (DTensor steps, "
              f"host clock, synchronised) {by_mesh}; peak GiB a rank over the DTensor steps "
              f"{ {k: round(v / 2**30, 2) for k, v in peaks.items()} }; checkpoint "
              f"{r0['ckpt_bytes'] / 1e9:.2f} GB saved in {r0['save_s']:.1f} s (async, then wait); "
              f"remesh from the verdict to the first resumed step's end {rem['total_s']:.2f} s "
              f"(failed ranks gone {rem['wait_s']:.2f} s, regroup + restore "
              f"{rem['regroup_restore_s']:.2f} s, first step {rem['first_step_s']:.2f} s); "
              f"restored bit for bit; launches of the DTensor steps {r0['launches']} "
              f"({steps} x {r0['per_step_launches']}); DTensor branches {r0['branches']}; wall "
              f"{wall:.1f} s")
    return dict(config=r0["config"], n_layers=r0["n_layers"], dtype=r0["dtype"], world=world,
                shrink_to=run.shrink_to, batch=run.batch, seq=run.seq, rows=rows,
                step_ms_by_mesh=by_mesh, peak_bytes=peaks, remesh=rem, save_s=r0["save_s"],
                ckpt_bytes=r0["ckpt_bytes"], launches=r0["launches"],
                per_step_launches=r0["per_step_launches"], branches=r0["branches"],
                restored_bitwise=r0["restored_bitwise"], wall_s=wall)


def phase_mesh(torch, card: str) -> dict:
    """Phase 8: h2o_danube_1_8b at full width (``MESH_LAYERS`` layers,
    bf16, wq/wk at the fan-in of d_model) trained under a (1, 1) mesh on one
    nccl rank (the script's own process starts no group), checkpointed
    sharded, remeshed by the elastic controller onto a fresh group of
    generation 1, restored and trained one more step (``mesh_phase``'s
    gates), each DTensor step launching the flash forward and backward on
    the rank's heads: the local branch of the DTensor entry, once a layer
    for the forward and once for the recompute."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "pids"))
        run = MeshRun(MESH_ARCH, MESH_LAYERS, "bfloat16", MESH_BATCH, MESH_SEQ, 3, 1, 1,
                      os.path.join(tmp, "ckpt"), os.path.join(tmp, "pids"))
        free, total = torch.cuda.mem_get_info()
        log(card, f"phase 8 starts one nccl rank on cuda:0 with {free / 2**30:.1f} of "
                  f"{total / 2**30:.1f} GiB free")
        out = mesh_phase(torch, card, run, 1, ["cuda:0"], "the mesh path")
    flash_fwd = out["launches"]["flash_attention"]
    if out["branches"] != {"local": flash_fwd, "replicate": 0}:
        raise AssertionError(f"DTensor branches {out['branches']}, expected {flash_fwd} local "
                             f"(one a flash forward)")
    return out


# -- phase 8: the MoE, MLA, encoder-decoder and VLM models under the mesh ----------
@dataclasses.dataclass(frozen=True)
class ArchMeshRun:
    """One arch trained under a ("data", "model") mesh of ``mesh`` (None: the
    plain one-card step, no DTensor): full width (the smoke-scale config
    where ``reduced``), ``layers`` of its depth (None: all; an
    encoder-decoder's encoder cut alike), ``overrides`` of its config, the
    dtype, batch x sequence, and ``steps`` AdamW steps, or with ``adamw``
    false that many loss-and-gradient passes. With ``compare``, before each
    step rank 0 gathers the whole state and takes the plain step (or pass)
    from it on its own card. ``qk_fan_in``: wq and wk at the fan-in of
    d_model (``fan_in_qk``)."""
    arch: str
    layers: Optional[int]
    dtype: str
    batch: int
    seq: int
    steps: int
    mesh: Optional[Tuple[int, int]] = (1, 1)
    adamw: bool = True
    compare: bool = True
    qk_fan_in: bool = False
    reduced: bool = False
    overrides: tuple = ()


def arch_mesh_cfg(run: ArchMeshRun):
    from repro_torch.configs import get_config, reduced_config
    full = reduced_config(run.arch) if run.reduced else get_config(run.arch)
    cfg = dataclasses.replace(full, n_layers=run.layers or full.n_layers, dtype=run.dtype,
                              **dict(run.overrides))
    if cfg.encdec and run.layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=run.layers)
    return full, cfg


def arch_mesh_rank(rank: int, world: int, runs) -> list:
    """The ``ArchMeshRun``s on this rank (started by ``run_ranks``, one
    process for all of them): the model drawn from seed 0 on the rank's
    device and laid out by ``ShardingRules``, AdamW state alike,
    ``TokenPipeline`` and the frontend stubs (``frontend_stubs``, seed 3)
    placing each batch on the mesh, ``make_train_step`` (remat="full"). Each
    step's loss, grad norm (a pass: each gradient's norm), host-clock ms
    (synchronised), peak bytes and launches; rank 0's plain step from the
    same state beside it (``compare``; in float32 also the state after it
    against the DTensor step's: the first moments within a share of each
    leaf's max, the parameters by the float32 tolerance); the rows of each
    expert leaf this rank holds. Returns the numbers; the gates are the
    caller's."""
    import torch

    from repro_torch import kernels
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.launch.steps import _plain, frontend_stubs, make_train_step
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.sharding_utils import distribute_tree
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime import ranks

    device = ranks.rank_device()
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = []
    for run in runs:
        full, cfg = arch_mesh_cfg(run)
        model, train_step = make_train_step(cfg, peak_lr=3e-4, warmup=2,
                                            total=max(run.steps, 2), remat="full",
                                            device=device)
        mesh = None if run.mesh is None else make_mesh(run.mesh, ("data", "model"),
                                                       device=device)
        params = fan_in_qk(cfg, model.init(torch.Generator(device=device).manual_seed(0)),
                           run.qk_fan_in)
        n_params = sum(t.numel() for t in tree_leaves(params))
        if mesh is not None:
            params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params),
                                     mesh)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        opt = adamw_init(params) if run.adamw else None
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq,
                                        global_batch=run.batch, seed=0), device=device,
                             mesh=mesh)
        stubs = frontend_stubs(cfg, run.batch, device,
                               torch.Generator(device=device).manual_seed(3), mesh=mesh)
        rows = {}
        for path, t in _named(params):
            if "/moe/w_" in path:
                rows[path] = (t.to_local() if hasattr(t, "to_local") else t).shape[
                    1 if path.startswith("/stack") else 0]
        rec = dict(rank=rank, world=world, arch=run.arch, config=full.name,
                   n_layers=cfg.n_layers, full_layers=full.n_layers, dtype=cfg.dtype,
                   batch=run.batch, seq=run.seq, mesh=run.mesh, params=n_params,
                   expert_rows=rows, per_step_launches=train_launches(cfg, run.seq),
                   steps=[], launches={k: 0 for k in kernels.KERNELS},
                   branches={"local": 0, "replicate": 0})

        def loss_grads(p, batch):
            """(loss, aux, {path: grad norm}) of one pass (no optimizer)."""
            leaves = list(tree_leaves(p))
            for t in leaves:
                t.requires_grad_(True)
            loss, met = model.loss(p, batch, remat="full")
            loss = _plain(loss)
            grads = torch.autograd.grad(loss, leaves)
            norms = {path: float(_plain(g.float().pow(2).sum()).sqrt())
                     for (path, _), g in zip(_named(p), grads)}
            del grads
            for t in leaves:
                t.requires_grad_(False)
            return float(loss), float(_plain(met["aux"])), norms

        def plain_step(state, batch, i):
            snap = gather(state, rank == 0)
            plain_batch = {k: _plain(v) for k, v in batch.items()}
            if rank != 0:
                return None
            sync()
            t0 = time.perf_counter()
            if not run.adamw:
                loss, aux, norms = loss_grads(snap["params"], plain_batch)
                ref = dict(loss=loss, aux=aux, grad_norms=norms)
            else:
                p, o, m = train_step(snap["params"], snap["opt"], plain_batch, i)
                ref = dict(loss=float(m["loss"]), aux=float(m["aux"]),
                           grad_norm=float(m["grad_norm"]))
                if cfg.dtype == "float32":
                    ref["state"] = {"params": p, "m": o["m"]}
            sync()
            ref["ms"] = (time.perf_counter() - t0) * 1e3
            return ref

        for i in range(run.steps):
            batch = {**next(data), **stubs}
            state = {"params": params, "opt": opt} if run.adamw else {"params": params}
            ref = plain_step(state, batch, i) if run.compare and mesh is not None else None
            del state
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            before, br = kernels.launch_counts(), dict(ops.dtensor_branch)
            sync()
            t0 = time.perf_counter()
            with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
                if run.adamw:
                    params, opt, m = train_step(params, opt, batch, i)
                    r = dict(loss=float(m["loss"]), aux=float(m["aux"]),
                             grad_norm=float(m["grad_norm"]))
                else:
                    loss, aux, norms = loss_grads(params, batch)
                    r = dict(loss=loss, aux=aux, grad_norms=norms)
            sync()
            r.update(step=i, ms=(time.perf_counter() - t0) * 1e3,
                     peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0)
            after = kernels.launch_counts()
            r["launches"] = {k: after[k] - before[k] for k in after}
            for k in after:
                rec["launches"][k] += r["launches"][k]
            for k in br:
                rec["branches"][k] += ops.dtensor_branch[k] - br[k]
            if run.compare and mesh is not None and run.adamw and cfg.dtype == "float32":
                st = gather({"params": params, "m": opt["m"]}, rank == 0)
                if rank == 0:
                    m_err, p_share = {}, {}
                    for (path, a), (_, b) in zip(_named(st), _named(ref.pop("state"))):
                        a, b = a.detach().float(), b.detach().float()
                        if path.startswith("/m/"):
                            m_err[path] = float((a - b).abs().max()
                                                / b.abs().max().clamp(min=1e-30))
                        else:
                            p_share[path] = bound_share(torch, a, b, "float32")[1]
                    wm, wp = max(m_err, key=m_err.get), max(p_share, key=p_share.get)
                    r["state_worst"] = dict(moment=wm, moment_rel_to_max=m_err[wm], param=wp,
                                            param_f32_share=p_share[wp])
                del st
            if ref is not None:
                r["plain"] = ref
            rec["steps"].append(r)
        data.close()
        out.append(rec)
        del params, opt, data, stubs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def arch_mesh_gate(torch, card: str, recs: list, what: str) -> list:
    """Gate and log the ``arch_mesh_rank`` records of ``world`` ranks (rank
    0's comparisons): every loss and grad norm finite; in bf16 on a (1, 1)
    mesh the loss bitwise and the grad norm (a pass: each gradient's norm)
    within ``MESH_ONE_GNORM_TOL`` relative of the plain step's; in float32
    loss and grad norm within ``MESH_ONE_GNORM_TOL`` relative, the first
    moments after each step within ``PIPE_GRAD_TOL`` of each leaf's max and
    the parameters within the float32 tolerance; on the card the DTensor
    steps' launches exact; every rank's expert leaves hold E / model-axis
    rows. Returns one summary a run."""
    from repro_torch.configs import get_config, reduced_config
    summaries = []
    for j, r0 in enumerate(recs[0]):
        name = f"{what} {r0['config']} ({r0['n_layers']} of {r0['full_layers']} layers, " \
               f"{r0['dtype']}, {r0['batch']} x {r0['seq']}) on {r0['mesh']}"
        for rk in recs:
            r = rk[j]
            for s in r["steps"]:
                vals = [s["loss"]] + ([s["grad_norm"]] if "grad_norm" in s
                                      else list(s["grad_norms"].values()))
                if not all(math.isfinite(v) for v in vals):
                    raise AssertionError(f"{name} rank {r['rank']} step {s['step']}: non-finite "
                                         f"loss or gradient")
            want = {k: v * len(r["steps"]) for k, v in r["per_step_launches"].items()}
            got = {k: v for k, v in r["launches"].items() if v}
            if DEVICE == "cuda" and got != want:
                raise AssertionError(f"{name} rank {r['rank']}: the DTensor steps launched "
                                     f"{got}, expected {want}")
            if r["mesh"] is not None and tuple(r["mesh"]) == (1, 1) and r["branches"]["replicate"]:
                raise AssertionError(f"{name}: the attention took the DTensor entry's replicate "
                                     f"branch {r['branches']['replicate']} times on a (1, 1) mesh")
            if r["mesh"] is not None and r["expert_rows"]:
                cfg = (reduced_config if r["config"].endswith("reduced") else get_config)(r["arch"])
                tp = r["mesh"][1]
                if set(r["expert_rows"].values()) != {cfg.n_experts // tp}:
                    raise AssertionError(f"{name} rank {r['rank']}: expert rows "
                                         f"{r['expert_rows']}, expected {cfg.n_experts // tp}")
        rows = []
        for s in r0["steps"]:
            p = s.get("plain")
            if p is None:
                continue
            worst_leaf = None
            if "grad_norms" in s:
                errs = {k: abs(s["grad_norms"][k] - v) / max(abs(v), 1e-30)
                        for k, v in p["grad_norms"].items()}
                worst_leaf = max(errs, key=errs.get)
                gn_rel = errs[worst_leaf]
                gn = (float(math.sqrt(sum(v * v for v in s["grad_norms"].values()))),
                      float(math.sqrt(sum(v * v for v in p["grad_norms"].values()))))
            else:
                gn_rel = abs(s["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
                gn = (s["grad_norm"], p["grad_norm"])
            loss_rel = abs(s["loss"] - p["loss"]) / abs(p["loss"])
            bitwise = s["loss"] == p["loss"]
            if r0["dtype"] == "float32":
                worst = s.get("state_worst")
                if (max(loss_rel, gn_rel) > MESH_ONE_GNORM_TOL
                        or (worst and (worst["moment_rel_to_max"] > PIPE_GRAD_TOL
                                       or worst["param_f32_share"] > 1.0))):
                    raise AssertionError(f"{name} step {s['step']}: loss rel err {loss_rel:.3e}, "
                                         f"grad norm rel err {gn_rel:.3e}, worst state {worst}")
            elif tuple(r0["mesh"]) == (1, 1):
                if not bitwise or gn_rel > MESH_ONE_GNORM_TOL:
                    raise AssertionError(
                        f"{name} step {s['step']}: loss {s['loss']!r} against the plain step's "
                        f"{p['loss']!r} (must be bitwise), grad norm rel err {gn_rel:.3e} "
                        f"(tol {MESH_ONE_GNORM_TOL}{f', leaf {worst_leaf}' if worst_leaf else ''})")
            rows.append(dict(step=s["step"], loss=s["loss"], plain_loss=p["loss"],
                             bitwise=bitwise, loss_rel_err=loss_rel, grad_norm=gn[0],
                             plain_grad_norm=gn[1], grad_norm_rel_err=gn_rel,
                             state_worst=s.get("state_worst"), ms=s["ms"], plain_ms=p["ms"]))
            log(card, f"{name} step {s['step']}: loss {s['loss']:.6f} (plain one-card step "
                      f"{p['loss']:.6f}, {'bitwise' if bitwise else f'rel err {loss_rel:.3e}'}), "
                      f"grad norm {gn[0]:.6f} (plain {gn[1]:.6f}; worst rel err "
                      f"{gn_rel:.3e}{f', leaf {worst_leaf}' if worst_leaf else ''})"
                      + (f", first moments' worst {s['state_worst']['moment']} at "
                         f"{s['state_worst']['moment_rel_to_max']:.3e} of its max, parameters' "
                         f"worst {s['state_worst']['param']} at "
                         f"{s['state_worst']['param_f32_share']:.3g} x the f32 tolerance"
                         if s.get("state_worst") else "")
                      + f"; {s['ms']:.1f} ms (plain {p['ms']:.1f} ms)")
        ms = [s["ms"] for s in r0["steps"]]
        timed = ms[1:9] if len(ms) > 2 else ms
        med = statistics.median(timed)
        _, cfg = arch_mesh_cfg(ArchMeshRun(r0["arch"], r0["n_layers"], r0["dtype"], r0["batch"],
                                           r0["seq"], 1, reduced=r0["config"].endswith("reduced")))
        flops = train_flops(cfg, r0["batch"], r0["seq"])
        n_cards = len(recs)
        mfu = flops / (med / 1e3) / (PEAK_OPS[r0["dtype"]] * n_cards)
        peaks = {rk[j]["rank"]: max(s["peak_bytes"] for s in rk[j]["steps"]) for rk in recs}
        losses = [s["loss"] for s in r0["steps"]]
        summary = dict(config=r0["config"], n_layers=r0["n_layers"], dtype=r0["dtype"],
                       batch=r0["batch"], seq=r0["seq"], mesh=r0["mesh"], params=r0["params"],
                       ranks=n_cards, losses=losses, ms=ms, ms_median=med,
                       tokens_s=r0["batch"] * r0["seq"] / med * 1e3, model_flops=flops,
                       mfu=mfu, peak_bytes=peaks, launches=r0["launches"],
                       branches=r0["branches"], expert_rows=r0["expert_rows"], rows=rows)
        log(card, f"{name}: {r0['params'] / 1e9:.3f} B parameters, {n_cards} rank(s); losses "
                  f"{[round(x, 4) for x in losses]}; step ms (host clock, synchronised) "
                  f"{[round(x, 1) for x in ms]}, median of {len(timed)} {med:.1f} ms, "
                  f"{summary['tokens_s']:.0f} tokens/s, {100 * mfu:.1f}% of {n_cards} x "
                  f"{PEAK_OPS[r0['dtype']] / 1e12:.0f} TFLOP/s; peak GiB a rank "
                  f"{ {k: round(v / 2**30, 2) for k, v in peaks.items()} }; expert rows a rank "
                  f"{sorted(set(r0['expert_rows'].values()))}; launches "
                  f"{ {k: v for k, v in r0['launches'].items() if v} }; DTensor attention "
                  f"branches {r0['branches']}")
        summaries.append(summary)
    return summaries


# phase 8's (1, 1)-mesh runs of the MoE, MLA, encoder-decoder and VLM models
# at full width, held to the plain one-card step as h2o's: olmoe 2 of 16
# layers at train_4k's 2 x 4096 (the flash forward and backward at G = 1 on
# the DTensor entry's local branch), 3 steps; deepseek's loss and gradients at
# 2 of 60 layers (the dense-first tail and one MoE unit, ~5.4 B parameters,
# no AdamW), 1 x 4096; whisper (2 + 2 layers, 8 x 448) and paligemma (2
# layers, 2 x (256 + 512)), one step each, wq and wk at the fan-in of d_model
MESH_ARCH_RUNS = [
    ArchMeshRun("olmoe_1b_7b", 2, "bfloat16", OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ, 3),
    ArchMeshRun("deepseek_v2_236b", 2, "bfloat16", DS_GRAD_BATCH, DS_GRAD_SEQ, 1, adamw=False),
    ArchMeshRun("whisper_small", 2, "bfloat16", WH_TRAIN_BATCH, WH_TRAIN_SEQ, 1, qk_fan_in=True),
    ArchMeshRun("paligemma_3b", 2, "bfloat16", PG_TRAIN_BATCH, PG_TRAIN_SEQ, 1, qk_fan_in=True),
]


def phase_mesh_archs(torch, card: str, runs=MESH_ARCH_RUNS) -> dict:
    """Phase 8's MoE, MLA, encoder-decoder and VLM runs on a (1, 1) mesh of
    one nccl rank (one process for all of them), gated by
    ``arch_mesh_gate``. On a (1, 1) mesh every placement replicates, so the
    runs drive DTensor's dispatch and the ``local_map`` entries (routing,
    dispatch, the expert products, the combine, MLA's heads, the NLL, the
    flash kernel's local branch) on the card."""
    from repro_torch.runtime.ranks import run_ranks

    free, total = torch.cuda.mem_get_info()
    log(card, f"phase 8's arch runs start one nccl rank on cuda:0 with {free / 2**30:.1f} of "
              f"{total / 2**30:.1f} GiB free")
    t0 = time.perf_counter()
    recs = run_ranks(arch_mesh_rank, 1, (runs,), backend="nccl", timeout=MESH_TIMEOUT,
                     devices=["cuda:0"])
    wall = time.perf_counter() - t0
    summaries = arch_mesh_gate(torch, card, recs, "mesh")
    log(card, f"phase 8's arch runs: wall {wall:.1f} s")
    return {s["config"]: dict(s, wall_s=wall) for s in summaries}

# -- phase 8: serving under the mesh ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeMeshRun:
    """One arch served through ``launch.serve.generate`` on a ("data",
    "model") mesh of ``mesh`` (parameters by ``param_specs``, the cache by
    ``cache_specs``, prompt, positions and stubs by ``batch_specs``) and,
    first in the same rank, on the rank's device alone: full
    width (the smoke-scale config where ``reduced``), ``layers`` of its depth
    (None: all; an encoder-decoder's encoder cut alike), the dtype, batch x
    prompt and ``gen`` greedy steps; the kernel launches the mesh run's
    prefill and each of its decode steps must make. ``qk_fan_in``: wq and wk
    at the fan-in of d_model (``fan_in_qk``)."""
    arch: str
    layers: Optional[int]
    dtype: str
    batch: int
    prompt: int
    gen: int
    prefill_launches: Dict[str, int]
    step_launches: Dict[str, int]
    mesh: Tuple[int, int] = (1, 1)
    qk_fan_in: bool = False
    reduced: bool = False
    overrides: tuple = ()


def decode_merges(cfg) -> int:
    """The attentions one decode step runs over a cache under a mesh, each a
    ``"sharded_keys"`` merge: every GQA and MLA layer, and an
    encoder-decoder's self- and cross-attention."""
    from repro_torch.models import build_model
    if cfg.encdec:
        return 2 * cfg.n_layers
    return sum(k not in ("ssm", "rec") for k in build_model(cfg, device="meta").layer_kinds())


def serve_mesh_rank(rank: int, world: int, runs) -> list:
    """The ``ServeMeshRun``s on this rank (started by ``run_ranks``, one
    process for all of them): the model drawn from seed 0 on the rank's
    device, a prompt from numpy seed 0 and the frontend stubs from seed 3;
    the plain serve first, then the mesh serve, each through
    ``generate``. Returns each run's tokens, every step's logits (rank 0),
    the launch counts of the mesh run (zeroed just before it, read after its
    prefill and at its end), the DTensor decode entry's branches over its
    decode steps, its times, peak memory and the cache's bytes a rank; the
    gates are the caller's."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import frontend_stubs
    from repro_torch.models import build_model
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.sharding_utils import distribute_tree
    from repro_torch.runtime import ranks

    device = ranks.rank_device()
    on_card = device.type == "cuda"
    out = []
    for run in runs:
        full, cfg = arch_mesh_cfg(run)
        model = build_model(cfg, device=device)
        params = fan_in_qk(cfg, model.init(torch.Generator(device=device).manual_seed(0)),
                           run.qk_fan_in)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (run.batch, run.prompt)), dtype=torch.int32, device=device)
        stubs = frontend_stubs(cfg, run.batch, device,
                               torch.Generator(device=device).manual_seed(3))
        rec = dict(rank=rank, world=world, arch=run.arch, config=full.name,
                   n_layers=cfg.n_layers, full_layers=full.n_layers, dtype=cfg.dtype,
                   batch=run.batch, prompt=run.prompt, gen=run.gen, mesh=run.mesh,
                   vocab=cfg.vocab_size, merges_per_step=decode_merges(cfg),
                   want_prefill={k: run.prefill_launches.get(k, 0) for k in kernels.KERNELS},
                   want={k: run.prefill_launches.get(k, 0) + run.gen * run.step_launches.get(k, 0)
                         for k in kernels.KERNELS})
        p = generate(model, params, tokens, stubs, run.gen, keep_logits=rank == 0)
        rec["plain"] = dict(tokens=p["tokens"].cpu(), logits=[x.cpu() for x in p["logits"]],
                            prefill_ms=p["prefill_ms"], decode_ms=p["decode_ms"])
        del p
        mesh = make_mesh(run.mesh, ("data", "model"), device=device)
        params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        snap = {}

        def after(i: int) -> None:
            if i < 0:
                snap.update(launches=kernels.launch_counts(), branches=dict(ops.decode_branch))
        kernels.reset_launches()
        # every rank gathers the logits (a collective); rank 0 keeps them
        m = generate(model, params, tokens, stubs, run.gen, mesh=mesh, keep_logits=True,
                     on_step=after)
        counts = kernels.launch_counts()
        cache_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                          for t in _leaves(m["cache"]))
        rec.update(tokens=m["tokens"].cpu(),
                   logits=[x.cpu() for x in m["logits"]] if rank == 0 else [],
                   prefill_ms=m["prefill_ms"], decode_ms=m["decode_ms"], launches=counts,
                   prefill_launch_counts=snap["launches"],
                   branches={k: ops.decode_branch[k] - snap["branches"][k]
                             for k in ops.decode_branch},
                   peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0,
                   cache_bytes=cache_bytes)
        out.append(rec)
        del params, m, mesh
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def serve_mesh_gate(torch, card: str, recs: list, what: str, logits_tol: float) -> list:
    """Gate and log the ``serve_mesh_rank`` records of every rank: the tokens
    within the vocabulary and equal to the plain serve's; every step's
    logits finite, their relative L2 error against the plain serve's at most
    ``logits_tol``; on the card the launches exact (after the prefill and at
    the end); every decode step one ``"sharded_keys"`` merge an attention
    and no ``"replicate"``. Returns one summary a run."""
    import statistics as st
    summaries = []
    for j, r0 in enumerate(recs[0]):
        name = f"{what} {r0['config']} ({r0['n_layers']} of {r0['full_layers']} layers, " \
               f"{r0['dtype']}, {r0['batch']} x {r0['prompt']} + {r0['gen']} steps) on " \
               f"{r0['mesh']}"
        for rk in recs:
            r = rk[j]
            toks = r["tokens"]
            if toks.shape != (r["batch"], r["gen"] + 1) or not bool(
                    ((toks >= 0) & (toks < r["vocab"])).all()):
                raise AssertionError(f"{name} rank {r['rank']}: tokens {tuple(toks.shape)} "
                                     f"outside the vocabulary or of the wrong shape")
            if not torch.equal(toks, r["plain"]["tokens"]):
                raise AssertionError(f"{name} rank {r['rank']}: the mesh's greedy tokens "
                                     f"{toks.tolist()} differ from the plain serve's "
                                     f"{r['plain']['tokens'].tolist()}")
            if DEVICE == "cuda" and (r["prefill_launch_counts"] != r["want_prefill"]
                                     or r["launches"] != r["want"]):
                raise AssertionError(f"{name} rank {r['rank']}: launches {r['launches']} "
                                     f"(after the prefill {r['prefill_launch_counts']}), "
                                     f"expected {r['want']} ({r['want_prefill']})")
            want_br = {"sharded_keys": r["gen"] * r["merges_per_step"], "replicate": 0}
            if r["branches"] != want_br:
                raise AssertionError(f"{name} rank {r['rank']}: decode branches "
                                     f"{r['branches']}, expected {want_br}")
        rel, bitwise = [], True
        for a, b in zip(r0["logits"], r0["plain"]["logits"]):
            a, b = a[:, :r0["vocab"]], b[:, :r0["vocab"]]
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                raise AssertionError(f"{name}: logits are not finite")
            rel.append(float((a - b).norm() / b.norm()))
            bitwise &= bool(torch.equal(a, b))
        if max(rel) > logits_tol:
            raise AssertionError(f"{name}: the mesh's logits against the plain serve's: "
                                 f"relative L2 {max(rel):.3e} > {logits_tol}")
        lat = r0["decode_ms"][1:] or r0["decode_ms"]
        summary = dict(config=r0["config"], n_layers=r0["n_layers"], dtype=r0["dtype"],
                       batch=r0["batch"], prompt=r0["prompt"], gen=r0["gen"], mesh=r0["mesh"],
                       ranks=len(recs), logits_rel_l2=max(rel), bitwise=bitwise,
                       prefill_ms=r0["prefill_ms"],
                       decode_p50_ms=st.median(lat), decode_p99_ms=float(
                           sorted(lat)[min(len(lat) - 1, int(0.99 * len(lat)))]),
                       plain_prefill_ms=r0["plain"]["prefill_ms"],
                       plain_decode_p50_ms=st.median(r0["plain"]["decode_ms"][1:]
                                                     or r0["plain"]["decode_ms"]),
                       launches=r0["launches"], branches=r0["branches"],
                       peak_bytes={rk[j]["rank"]: rk[j]["peak_bytes"] for rk in recs},
                       cache_bytes={rk[j]["rank"]: rk[j]["cache_bytes"] for rk in recs})
        log(card, f"{name}: greedy tokens equal to the plain serve's on every rank; logits "
                  f"against the plain serve's: worst relative L2 "
                  f"{summary['logits_rel_l2']:.3e}{' (bitwise)' if bitwise else ''} (tol "
                  f"{logits_tol}); prefill {r0['prefill_ms']:.1f} ms (plain "
                  f"{summary['plain_prefill_ms']:.1f}), decode p50 "
                  f"{summary['decode_p50_ms']:.2f} ms (plain "
                  f"{summary['plain_decode_p50_ms']:.2f}) p99 "
                  f"{summary['decode_p99_ms']:.2f} ms (host clock, synchronised); launches "
                  f"{ {k: v for k, v in r0['launches'].items() if v} }; decode branches "
                  f"{r0['branches']}; peak GiB a rank "
                  f"{ {k: round(v / 2**30, 2) for k, v in summary['peak_bytes'].items()} }, "
                  f"cache GiB a rank "
                  f"{ {k: round(v / 2**30, 3) for k, v in summary['cache_bytes'].items()} }")
        summaries.append(summary)
    return summaries


# phase 8's serving runs on a (1, 1) mesh of one nccl rank, one a cache kind, at
# full width: qwen3 (GQA, G = 8) at 8 of 64 layers; h2o (d = 80) over a 4096
# prompt, so its 4096-slot ring wraps at every step; deepseek's MLA latents; mamba2's
# SSM state; recurrentgemma's RG-LRU state and local attention (d = 256, its
# 2048-slot ring wrapping) at 3 layers (one (rec, rec, local_attn) unit); olmoe's
# MoE at G = 1; whisper's cross cache, in float32 (the one-card decode takes the
# plain cross-attention, the mesh the decode kernel: in bf16 their roundings differ
# and a near tie of random logits would move a greedy token); paligemma's patch
# prefix. 2 layers each otherwise, batch 4, 8 steps. On (1, 1) every placement
# replicates: the runs drive the sharded-keys branch with no merge to do
SERVE_MESH_GEN = 8
SERVE_MESH_RUNS = [
    ServeMeshRun("qwen3_32b", LAYERS, "bfloat16", BATCH, 512, SERVE_MESH_GEN, {},
                 {"decode_attention": LAYERS}),
    ServeMeshRun("h2o_danube_1_8b", 2, "bfloat16", BATCH, PROMPT, SERVE_MESH_GEN,
                 {"flash_attention": 2}, {"decode_attention": 2}, qk_fan_in=True),
    ServeMeshRun("deepseek_v2_236b", 2, "bfloat16", BATCH, 512, SERVE_MESH_GEN, {}, {}),
    ServeMeshRun("mamba2_780m", 2, "bfloat16", BATCH, 512, SERVE_MESH_GEN, {"ssd_scan": 2},
                 {}),
    ServeMeshRun("recurrentgemma_9b", 3, "bfloat16", BATCH, RG_PROMPT, SERVE_MESH_GEN,
                 {"rglru_scan": 2}, {"decode_attention": 1}),
    ServeMeshRun("olmoe_1b_7b", 2, "bfloat16", BATCH, 512, SERVE_MESH_GEN, {},
                 {"decode_attention": 2}),
    ServeMeshRun("whisper_small", 2, "float32", BATCH, WH_PROMPT, SERVE_MESH_GEN, {},
                 {"decode_attention": 4}, qk_fan_in=True),
    ServeMeshRun("paligemma_3b", 2, "bfloat16", BATCH, PG_PROMPT, SERVE_MESH_GEN, {},
                 {"decode_attention": 2}, qk_fan_in=True),
]


def phase_serve_mesh(torch, card: str, runs=SERVE_MESH_RUNS) -> dict:
    """Phase 8's serving runs on a (1, 1) mesh of one nccl rank (one
    process for all of them), gated by ``serve_mesh_gate`` against the
    plain serve in the same rank (phase 3's decode-vs-prefill bound on the
    logits)."""
    from repro_torch.runtime.ranks import run_ranks

    free, total = torch.cuda.mem_get_info()
    log(card, f"phase 8's serving runs start one nccl rank on cuda:0 with {free / 2**30:.1f} of "
              f"{total / 2**30:.1f} GiB free")
    t0 = time.perf_counter()
    recs = run_ranks(serve_mesh_rank, 1, (runs,), backend="nccl", timeout=MESH_TIMEOUT,
                     devices=["cuda:0"])
    wall = time.perf_counter() - t0
    summaries = serve_mesh_gate(torch, card, recs, "serving mesh", DECODE_PREFILL_TOL)
    log(card, f"phase 8's serving runs: wall {wall:.1f} s")
    return {s["config"]: dict(s, wall_s=wall) for s in summaries}


# -- serving a long cache on four cards (tests/test_torch_gpu.py) -----------------
@dataclasses.dataclass(frozen=True)
class ServeLongRun:
    """A long-cache serve at full width: ``layers`` of the arch's depth,
    batch x prompt, ``gen`` greedy steps into a ``max_len``-slot cache, on a
    ("data", "model") mesh of ``mesh`` (None: one card, no DTensor), then
    (``check``) a fresh prefill of the prompt and the fed tokens on the same
    mesh, whose last logits the last decode step's are held to.
    ``overrides`` of the config (an MoE model's lossless capacity)."""
    arch: str
    layers: Optional[int]
    dtype: str
    batch: int
    prompt: int
    gen: int
    max_len: int
    mesh: Optional[Tuple[int, int]] = (1, 4)
    check: bool = True
    overrides: tuple = ()


def init_params_on_mesh(model, mesh, seed: int):
    """Random parameters laid out by ``param_specs`` on ``mesh`` with no whole
    copy of the model on any rank: stacked unit u is drawn from generator
    seed ``seed + u`` as the single unit of a model cut to one unit (the
    tail and the other leaves from the first), and each rank keeps its own
    shard of it."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.sharding import ShardingRules, map_with_path
    from repro_torch.models.sharding_utils import distribute, zeros_on_mesh
    cfg = model.cfg
    unit, n_units, tail = model.scan_groups()
    one = build_model(dataclasses.replace(cfg, n_layers=len(unit) + len(tail)),
                      device=model.device)
    rules = ShardingRules(cfg, mesh)

    def alloc(path, t):
        if path.startswith("stack/"):
            shape = (n_units,) + tuple(t.shape[1:])
            return zeros_on_mesh(shape, t.dtype, rules.param_spec(path, shape), mesh,
                                 model.device)
        return distribute(t, rules.param_spec(path, t.shape), mesh)
    out = None
    for u in range(n_units):
        part = one.init(torch.Generator(device=model.device).manual_seed(seed + u))
        if out is None:
            out = map_with_path(alloc, part)
        for path, t in _named(part["stack"], "stack"):
            path = path.strip("/")
            shape = (n_units,) + tuple(t.shape[1:])
            dst = out
            for key in path.split("/"):
                dst = dst[key]
            dst.to_local()[u].copy_(
                distribute(t[0], rules.param_spec(path, shape)[1:], mesh).to_local())
        del part
    return out


def serve_long_rank(rank: int, world: int, run: ServeLongRun) -> dict:
    """``ServeLongRun`` on this rank (one card a rank): the model from
    ``init_params_on_mesh`` (on one card ``model.init``), a prompt from
    numpy seed 0, ``generate`` into a ``max_len``-slot cache; the prefill's
    and every step's host-clock ms, the launches (zeroed before, read after),
    peak memory and the cache's bytes a rank; a profiler window over three
    decode steps on rank 0 (the other ranks run them too) with the device
    time of the decode kernel and of the collectives; then the fresh
    prefill's last logits beside the last step's (rank 0)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import lay_out_serving
    from repro_torch.models import build_model
    from repro_torch.runtime import ranks

    device = ranks.rank_device()
    full = get_config(run.arch)
    cfg = dataclasses.replace(full, n_layers=run.layers or full.n_layers, dtype=run.dtype,
                              **dict(run.overrides))
    model = build_model(cfg, device=device)
    mesh = None if run.mesh is None else make_mesh(run.mesh, ("data", "model"), device=device)
    t0 = time.perf_counter()
    params = (model.init(torch.Generator(device=device).manual_seed(0)) if mesh is None
              else init_params_on_mesh(model, mesh, 0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum((t.to_local() if hasattr(t, "to_local") else t).numel()
                      * t.element_size() for t in _leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (run.batch, run.prompt)), dtype=torch.int32, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = generate(model, params, tokens, {}, run.gen, mesh=mesh, keep_logits=True,
                   max_len=run.max_len)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cache = out["cache"]
    cache_bytes = sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
                      for t in _leaves(cache))
    rec = dict(rank=rank, world=world, config=full.name, n_layers=cfg.n_layers,
               full_layers=full.n_layers, dtype=cfg.dtype, batch=run.batch, prompt=run.prompt,
               gen=run.gen, max_len=run.max_len, mesh=run.mesh, init_s=init_s,
               param_bytes=param_bytes, prefill_ms=out["prefill_ms"],
               decode_ms=out["decode_ms"], launches=launches, peak_bytes=peak,
               cache_bytes=cache_bytes, tokens=out["tokens"].cpu(), vocab=cfg.vocab_size)
    # three decode steps again (the last slot rewritten) under the profiler on rank 0
    B = run.batch
    step = {"token": out["tokens"][:, -1:].to(device),
            "pos": torch.full((B,), run.prompt + run.gen - 1, dtype=torch.int32, device=device)}
    if mesh is not None:
        step = lay_out_serving(cfg, mesh, step, B)
    card = f"rank {rank}"

    def steps():
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            for _ in range(3):
                model.decode(params, step["token"], cache, step["pos"])
    if rank == 0:
        rec["profile"] = profile(torch, steps, card, f"three {cfg.name} decode steps on "
                                 f"{run.mesh}", {"decode kernel": "decode_",
                                                 "collectives": "nccl"})
    else:
        steps()
        torch.cuda.synchronize()
    if run.check:
        last = out["logits"][-1] if rank == 0 else None
        del cache, out
        gc.collect()
        torch.cuda.empty_cache()
        seq = torch.cat([tokens, rec["tokens"][:, :run.gen].to(device)], dim=1)
        fresh = generate(model, params, seq, {}, 0, mesh=mesh, keep_logits=True,
                         max_len=run.max_len)
        if rank == 0:
            a, b = last[:, :cfg.vocab_size], fresh["logits"][0][:, :cfg.vocab_size]
            rec["check"] = dict(rel_l2=float((a - b).norm() / b.norm()),
                                max_abs_err=float((a - b).abs().max()),
                                finite=bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                                argmax_equal=float((a.argmax(-1) == b.argmax(-1)).float().mean()),
                                fresh_prefill_ms=fresh["prefill_ms"])
    return rec


# ==============================================================================
# phase 9: the examples
# ==============================================================================
EXAMPLE_SMART_HOME_STEPS = (20, 40)     # a first run, then a restart from its checkpoint
# the traffic-monitor example's decode (B, cache slots, H, KV, d): 4 streams, prompt 16 +
# 32 steps of the reduced qwen3 in float32; phase 2 holds the kernel at this shape
TRAFFIC_DECODE = (4, 48, 8, 2, 16)


def _with_card(card: str, fn):
    """``fn()`` with its standard output printed after it, a line at a time
    with the card's name (an example's own prints carry none)."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn()
    finally:
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(card, "  " + line)


def phase_examples(torch, card: str) -> dict:
    """The port's examples through their ``main`` on the card: the smart-home
    example trains 20 steps and checkpoints, a second run resumes at step 20
    and trains to 40 (its 128-token sequences stay below attn_chunk: no
    launch); the traffic-monitor example replays its dynamics timeline and
    decodes greedily, one decode kernel a layer a step (d = 16, float32),
    counted exactly, its tokens equal to the same greedy decode of CPU
    copies of its weights (the plain path)."""
    import importlib
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    sys.path.insert(0, os.path.join(REPO, "examples"))
    smart_home = importlib.import_module("smart_home_training_torch")
    traffic = importlib.import_module("traffic_monitor_serving_torch")
    none = {k: 0 for k in kernels.KERNELS}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs = [_with_card(card, lambda n=n: smart_home.main(
            ["--steps", str(n), "--ckpt-dir", tmp, "--device", DEVICE]))
            for n in EXAMPLE_SMART_HOME_STEPS]
        wall_s = time.perf_counter() - t0
    first, second = runs
    counts = kernels.launch_counts()
    log(card, f"smart_home_training_torch: plan {first['plan'].best.summary()}; "
              f"{first['n_params'] / 1e6:.1f}M parameters; loss {first['first']:.4f} -> "
              f"{first['final']:.4f} over steps 0-{EXAMPLE_SMART_HOME_STEPS[0] - 1}, resumed at "
              f"step {second['step0']}, {second['first']:.4f} -> {second['final']:.4f} to step "
              f"{EXAMPLE_SMART_HOME_STEPS[1] - 1}; {wall_s:.1f} s; launches {counts}")
    losses = first["losses"] + second["losses"]
    if not (second["step0"] == EXAMPLE_SMART_HOME_STEPS[0]
            and second["opt_count"] == EXAMPLE_SMART_HOME_STEPS[1]
            and len(losses) == EXAMPLE_SMART_HOME_STEPS[1]
            and all(math.isfinite(x) for x in losses) and second["final"] < first["first"]):
        raise AssertionError(f"the smart-home example did not resume and train: {runs}")
    if counts != none:
        raise AssertionError(f"the smart-home example launched {counts}")
    out["smart_home"] = dict(first=first["first"], final=second["final"], losses=losses,
                             resumed_at=second["step0"], wall_s=wall_s, launches=counts)

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = _with_card(card, lambda: traffic.main(["--device", DEVICE]))
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = dict(none, decode_attention=res["n_layers"] * res["decode_steps"])
    log(card, f"traffic_monitor_serving_torch: {res['trace'].qoe_violations} QoE violations over "
              f"{len(res['trace'].steps)} events; {res['tokens'].shape[0]} streams x "
              f"{res['tokens'].shape[1] - 1} greedy tokens in {res['seconds']:.3f} s; "
              f"{wall_s:.1f} s; launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"the traffic-monitor example launched {counts}, expected {want}")
    cfg = reduced_config("qwen3_32b")
    shape = (traffic.B, traffic.PROMPT + traffic.GEN, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if shape != TRAFFIC_DECODE:
        raise AssertionError(f"the traffic-monitor example decodes at {shape}; phase 2 holds "
                             f"the kernel at TRAFFIC_DECODE = {TRAFFIC_DECODE}")
    cpu_tokens, _ = traffic.greedy(build_model(cfg, device="cpu"), _to(res["params"], "cpu"),
                                   res["prompt"], traffic.GEN)
    same = int((cpu_tokens == res["tokens"]).sum())
    log(card, f"traffic_monitor_serving_torch: {same} of {cpu_tokens.numel()} greedy tokens "
              f"equal to the CPU's from copies of the same weights")
    if not torch.equal(cpu_tokens, res["tokens"]):
        raise AssertionError(f"the traffic-monitor example's tokens on the card differ from "
                             f"the CPU's: {res['tokens'].tolist()} against {cpu_tokens.tolist()}")
    out["traffic_monitor"] = dict(decode_s=res["seconds"], wall_s=wall_s, launches=counts,
                                  qoe_violations=res["trace"].qoe_violations,
                                  tokens_equal_cpu=same)
    return out


# ==============================================================================
# phase 10: the dry-run, and its FLOP count tied to a real step on the card
# ==============================================================================
# two shallow production cells on fake "cuda" tensors on the fake (16, 16) mesh
DRYRUN_CELLS = (("qwen3_32b", "decode_32k"), ("h2o_danube_1_8b", "train_4k"))
DRYRUN_UNITS = 2
# the real step beside its dry-run: h2o-danube-1.8b at 2 of 24 layers, train_4k's
# sequence at batch 1
DRYRUN_ARCH, DRYRUN_LAYERS = "h2o_danube_1_8b", 2
# the decode wrapper's host cost: calls a reading, readings (the best kept)
HOST_CALLS, HOST_READS = 2000, 7
HOST_DECODE = (1, 64, 8, 2, 64)       # B, T, H, KV, d: a kernel shorter than its host cost


def host_us(torch, fn, calls: int, reads: int = HOST_READS) -> float:
    """Host time of one ``fn()`` in microseconds: ``calls`` back to back with
    no sync between them, the best of ``reads`` readings (the card's queue
    drained after each)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reads):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e6


def phase_dryrun(torch, card: str) -> dict:
    """``launch/dryrun.py`` on the card machine (its torch is built with CUDA,
    so the dry-run's tensors are fake ``"cuda"`` ones and the kernel wrappers
    hold them to the card's checks):

    (a) ``DRYRUN_CELLS`` at ``DRYRUN_UNITS`` units on the fake (16, 16) mesh,
        each to a record, no kernel launched;
    (b) h2o-danube-1.8b at 2 layers, 1 x 4096: the dry-run on a fake one-rank
        mesh, and the real train step on the card under ``FlopCounterMode``;
        the card's kernels are invisible to the counter, so its count must
        equal the dry-run's ``per_device_flops - kernel_flops`` exactly;
    (c) the dry-run's ``peak_gb`` beside the real step's
        ``torch.cuda.max_memory_allocated()`` and their ratio (a reading);
    (d) the decode wrapper's host cost on one call, and the same less the
        shape-only test the wrapper added (``shape_only.data_free`` on a card
        tensor): the parent's path, which is the same code without it."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import shape_only
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    if dist.is_initialized():
        raise AssertionError("phase_dryrun: a process group is already up in this process")
    out = {"cells": []}
    kernels.reset_launches()
    for arch, shape in DRYRUN_CELLS:                                      # (a)
        rec = dryrun.run_cell(arch, SHAPES[shape], False, units=DRYRUN_UNITS, device=DEVICE)
        if dist.is_initialized() or rec["device"] != DEVICE or not (
                rec["memory"]["peak_gb"] > 0 and rec["per_device_flops"] > 0
                and all(math.isfinite(v) for v in rec["memory"].values())):
            raise AssertionError(f"dry-run {arch} x {shape}: {rec}")
        r = rec["roofline"]
        log(card, f"dry-run {arch} x {shape} x 16x16 at {DRYRUN_UNITS} units on fake {DEVICE} "
                  f"tensors: {rec['lower_s']} s, peak {rec['memory']['peak_gb']:.3f} GB, "
                  f"{rec['per_device_flops']:.4e} FLOPs ({rec['kernel_flops']} in kernels), "
                  f"{rec['per_device_bytes']:.4e} B, collectives {rec['collectives']}, "
                  f"bound {r['bound']} ({dryrun.ESTIMATE})")
        out["cells"].append(rec)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the dry-run launched {kernels.launch_counts()}")

    cfg = dataclasses.replace(get_config(DRYRUN_ARCH), n_layers=DRYRUN_LAYERS)   # (b)
    shape = ShapeSpec("train_4k_batch_1", SHAPES["train_4k"].seq_len, 1, "train")
    dry = dryrun.run_one_rank(cfg, shape, device=DEVICE)
    besides = dry["per_device_flops"] - sum(dry["kernel_flops"].values())
    model, step = make_train_step(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    opt = adamw_init(params)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, shape.seq_len + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with FlopCounterMode(display=False) as counter:
        _, _, metrics = step(params, opt, batch, 0)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    real_flops = counter.get_total_flops()
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    log(card, f"dry-run identity, {DRYRUN_ARCH} {DRYRUN_LAYERS} layers, 1 x {shape.seq_len}: "
              f"per_device_flops {dry['per_device_flops']:.0f} - kernel_flops "
              f"{sum(dry['kernel_flops'].values()):.0f} = {besides:.0f}; the card's step "
              f"under FlopCounterMode {real_flops} (loss {loss:.4f}, launches {launches})")
    if besides != real_flops:
        raise AssertionError(f"the dry-run's FLOPs besides the kernels {besides} != the card "
                             f"step's count {real_flops}")
    if not math.isfinite(loss) or not launches["flash_attention"] \
            or not launches["flash_attention_bwd"]:
        raise AssertionError(f"the card's step: loss {loss}, launches {launches}")
    ratio = dry["memory"]["peak_gb"] * 1e9 / peak                                # (c)
    log(card, f"dry-run peak {dry['memory']['peak_gb']:.4f} GB (MemTracker on fake tensors) "
              f"beside the card step's max_memory_allocated {peak / 1e9:.4f} GB: ratio "
              f"{ratio:.4f}")
    del params, opt, batch, model, step
    gc.collect()
    torch.cuda.empty_cache()

    B, T, H, KV, d = HOST_DECODE                                                   # (d)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    q = torch.randn(B, 1, H, d, device=DEVICE, generator=g).to(torch.bfloat16)
    kc, vc = (torch.randn(B, T, KV, d, device=DEVICE, generator=g).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.full((B,), T, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        wrapper = host_us(torch, lambda: dec.decode_attention(q, kc, vc, lens), HOST_CALLS)
        test = host_us(torch, lambda: shape_only.data_free(q), 50 * HOST_CALLS)
    log(card, f"decode wrapper host cost at B={B}, T={T}, H={H}, KV={KV}, d={d} bf16: "
              f"{wrapper:.3f} us a call with the shape-only test, {wrapper - test:.3f} us "
              f"without it (the test alone {test:.4f} us; best of {HOST_READS} x {HOST_CALLS})")
    out.update(arch=DRYRUN_ARCH, layers=DRYRUN_LAYERS, dry=dry, real_flops=real_flops,
               besides_kernels=besides, real_peak_gb=peak / 1e9, peak_ratio=ratio, loss=loss,
               launches=launches, host_us={"wrapper": wrapper, "without_test": wrapper - test,
                                           "test": test, "shape": list(HOST_DECODE)})
    return out


def _to(tree, device):
    """A copy of ``tree`` on ``device`` (a copy on the same device too: the
    train step updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def _kernel_name(mangled: str) -> str:
    """``flash_wgmma_kernel<256,64>`` from a mangled kernel name."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled) or re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n, at = int(m.group(1)), m.end()
    name, rest = mangled[at:at + n], mangled[at + n:]
    args = []
    if rest.startswith("I"):
        rest = rest[1:]
        while rest and not rest.startswith("E"):
            lit = re.match(r"Li(\d+)E", rest)
            if lit:
                args.append(lit.group(1))
                rest = rest[lit.end():]
            elif rest.startswith("13__nv_bfloat16"):
                args.append("bf16")
                rest = rest[15:]
            elif rest.startswith("f"):
                args.append("float")
                rest = rest[1:]
            else:
                break
    return f"{name}<{','.join(args)}>" if args else name


def sass_count(source: str, op: str) -> Dict[str, int]:
    """Instructions of opcode ``op`` (HMMA: mma.sync, HGMMA: wgmma) in each
    kernel's SASS (``cuobjdump -sass`` of the built library);
    raises where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError(f"cuobjdump not found: the {op} check of {source} cannot run")
    sass = subprocess.run([tool, "-sass", str(_build._target(source))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{op}\b", line):
            counts[fn] += 1
    return counts


def ptxas_record(logs: Dict[str, str]) -> list:
    """Registers, stack and spills of every compiled kernel (``nvcc -Xptxas
    -v``), with the dynamic shared memory a block of the attention kernels
    and the SSD stages asks for."""
    import ctypes
    from repro_torch.kernels import _build
    smem = {}
    for src in ("flash_attention", "decode_attention"):
        fn = getattr(ctypes.CDLL(str(_build._target(src))), f"{src}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        smem[src] = fn
    ssd_smem = ctypes.CDLL(str(_build._target("ssd_scan"))).ssd_scan_smem_bytes
    ssd_smem.argtypes, ssd_smem.restype = [ctypes.c_int], ctypes.c_int
    bwd_smem = ctypes.CDLL(str(_build._target("flash_attention_bwd"))).flash_attention_bwd_smem_bytes
    bwd_smem.argtypes, bwd_smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    bwd_ssd_smem = ctypes.CDLL(str(_build._target("ssd_scan_bwd"))).ssd_scan_bwd_smem_bytes
    bwd_ssd_smem.argtypes, bwd_ssd_smem.restype = [ctypes.c_int], ctypes.c_int
    ssd_stage = {"ssd_kernel": 0, **{k: i + 1 for i, k in enumerate(SSD_STAGES)}}
    bwd_ssd_stage = {"ssd_bwd_state_kernel": 0, "ssd_bwd_chunk_kernel": 1,
                     "ssd_bwd_chunk_state_kernel": 2, "ssd_bwd_dcb_kernel": 3,
                     "ssd_bwd_dx_kernel": 4, "ssd_bwd_dbdc_kernel": 5}
    out = []
    for src, text in logs.items():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)", line)
            if m:
                cur = dict(source=src, function=_kernel_name(m.group(1)))
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["static_smem"] = int(m.group(1))
    for r in out:
        fn = r["function"]
        args = fn[fn.find("<") + 1:-1].split(",") if "<" in fn else []
        dims = [int(a) for a in args if a.isdigit()]
        if r["source"] in smem and dims and "combine" not in fn:
            dtype = 0 if ("f32" in fn or "fwd_kernel" in fn) else 1
            r["dynamic_smem"] = smem[r["source"]](dtype, dims[0])
        if r["source"] == "ssd_scan":
            r["dynamic_smem"] = ssd_smem(ssd_stage[fn.split("<")[0]])
        if r["source"] == "ssd_scan_bwd" and fn in bwd_ssd_stage:
            r["dynamic_smem"] = bwd_ssd_smem(bwd_ssd_stage[fn])
        if r["source"] == "flash_attention_bwd" and dims:      # wgmma / f32 dk/dv (0), f32 dq (1)
            r["dynamic_smem"] = bwd_smem(0 if "f32" in fn else 1, dims[-1],
                                         1 if "dq_f32" in fn else 0)
    counts = {"ssd_scan": ("hmma", sass_count("ssd_scan", "HMMA")),
              "ssd_scan_bwd": ("hmma", sass_count("ssd_scan_bwd", "HMMA")),
              "flash_attention_bwd": ("hgmma", sass_count("flash_attention_bwd", "HGMMA"))}
    for r in out:
        if r["source"] in counts and r["function"] in counts[r["source"]][1]:
            key, by_fn = counts[r["source"]]
            r[key] = by_fn[r["function"]]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 1: the device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    log(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
                         "ssd_scan_bwd", "rglru_scan"])
    log(card, f"built the kernels in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    ptxas = ptxas_record(logs)
    for r in ptxas:
        log(card, f"ptxas {r['source']}.cu {r['function']}: {r.get('registers')} registers, "
                  f"{r.get('stack', 0)} B stack, spill stores {r.get('spill_stores', 0)} B, "
                  f"spill loads {r.get('spill_loads', 0)} B, dynamic shared memory "
                  f"{r.get('dynamic_smem', 'none')}"
                  + (f", {r['hmma']} HMMA in its SASS" if "hmma" in r else "")
                  + (f", {r['hgmma']} HGMMA in its SASS" if "hgmma" in r else ""))
    # the bf16 SSD stages that multiply, forward and backward, run on the tensor cores
    hmma = {r["function"]: r.get("hmma", 0) for r in ptxas
            if r["source"] in ("ssd_scan", "ssd_scan_bwd")}
    no_hmma = [k for k in SSD_STAGES + SSD_BWD_STAGES
               if k not in ("ssd_state_passing_kernel", "ssd_bwd_state_passing_kernel",
                            "ssd_bwd_da_kernel") and not hmma.get(k)]
    if no_hmma:
        raise AssertionError(f"no HMMA in the SASS of {no_hmma} (found {hmma})")
    # the bf16 flash backward's main kernel runs on wgmma, in every instance
    hgmma = {r["function"]: r.get("hgmma", 0) for r in ptxas
             if r["function"].startswith("flash_bwd_wgmma_kernel")}
    if len(hgmma) != 4 or not all(hgmma.values()):
        raise AssertionError(f"flash_bwd_wgmma_kernel instances without HGMMA: {hgmma}")
    spills = [r["function"] for r in ptxas if r["source"] == "flash_attention_bwd"
              and (r.get("spill_stores", 0) or r.get("spill_loads", 0))]
    if spills:
        raise AssertionError(f"the flash backward kernels spill: {spills}")

    phase_s = {"build": time.perf_counter() - t_start}

    def timed(name: str, t0: float) -> None:
        phase_s[name] = time.perf_counter() - t0
        log(card, f"phase {name} took {phase_s[name]:.1f} s (host clock)")

    t0 = time.perf_counter()
    kern = phase_kernels(torch, card)        # phase 2
    timed("2 kernels", t0)
    t0 = time.perf_counter()
    serve = {}
    for path in PATHS:                       # phase 3
        t1 = time.perf_counter()
        serve[path.arch] = phase_serve(torch, card, path)
        serve[path.arch]["seconds"] = time.perf_counter() - t1
        log(card, f"serving {path.arch} took {serve[path.arch]['seconds']:.1f} s (host clock)")
        gc.collect()
        torch.cuda.empty_cache()
    timed("3 serving", t0)
    t0 = time.perf_counter()
    small = []
    for spec in SMALL:                       # phase 4
        t1 = time.perf_counter()
        small.append(phase_small_model(torch, card, *spec))
        log(card, f"small {spec[0]} took {time.perf_counter() - t1:.1f} s (host clock)")
    small_train = [phase_small_train(torch, card, *spec) for spec in SMALL_TRAIN]
    timed("4 small models", t0)
    t0 = time.perf_counter()
    train = {}
    for tpath in TRAIN_PATHS:                # phase 5
        gc.collect()
        torch.cuda.empty_cache()
        train[tpath.arch] = phase_train(torch, card, tpath)
    gc.collect()
    torch.cuda.empty_cache()
    grads = phase_grads(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_launcher = phase_train_launcher(torch, card)
    timed("5 training", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dora = phase_dora(torch, card)           # phase 6
    timed("6 Dora plans", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    calibration = phase_calibrate(torch, card)   # phase 7
    timed("7 calibration", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = phase_mesh(torch, card)           # phase 8
    gc.collect()
    torch.cuda.empty_cache()
    mesh_archs = phase_mesh_archs(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    serve_mesh = phase_serve_mesh(torch, card)
    timed("8 mesh", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples = phase_examples(torch, card)   # phase 9
    timed("9 examples", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = phase_dryrun(torch, card)          # phase 10
    timed("10 dry-run", t0)

    # the backward has no Pallas kernel: it replaces the gradient the JAX
    # package takes through its rematerialised query-chunked attention
    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:35"),
               "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                       "src/repro/models/attention.py:84"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:30"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:34"),
               # no Pallas kernel: the gradient the JAX package takes through ssd_chunked
               "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                                "src/repro/models/ssm.py:28"),
               "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                              "src/repro/kernels/rglru_scan.py:34"),
               # no Pallas kernel: the gradient the JAX package takes through its
               # associative-scan oracle
               "rglru_scan_bwd": ("src/repro_torch/csrc/rglru_scan.cu",
                                  "src/repro/models/rglru.py:52")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "bound_share", "tol", "shape")
    kernels_line = {"kernels": []}
    # the main entry is each kernel's qwen3-32b (or only) shape; the other
    # timed shapes ride beside it, each with the same keys
    extra = {"flash_attention": ("d256", "d80", "g48", "g1", "g1_train"),
             "decode_attention": ("d256", "d80", "g48", "d16", "g1", "whisper", "paligemma",
                                  "partial"),
             "flash_attention_bwd": ("d80", "g48", "d256", "g1"), "rglru_scan": ("train",)}
    extra_key = {"d256": "head_dim_256", "d80": "head_dim_80", "g48": "group_48",
                 "g1": "group_1", "d16": "head_dim_16", "train": "training_shape",
                 "g1_train": "group_1_training_shape",
                 "whisper": "whisper_d64_group_1", "paligemma": "paligemma_d256_group_8",
                 "partial": "sharded_keys_quarter_shard"}
    for name in sources:
        by_path = {arch: r["launches"][name] for arch, r in serve.items()}
        by_path.update({f"{arch} train": r["launches"][name] for arch, r in train.items()})
        by_path.update({f"{dora[k]['arch']} {label}": dora[k]["launches"][name]
                        for k, label in (("forward", "pipeline forward"),
                                         ("gradients", "pipeline gradients"),
                                         ("launcher", "planning launcher"),
                                         ("catalogue_launcher", f"{CATALOGUE} launcher"),
                                         ("catalogue_replan",
                                          f"{CATALOGUE} replanned pipeline forward"))})
        by_path.update({f"{dora['ranks'][k]['arch']} pipeline ranks {k}":
                        dora["ranks"][k]["launches"][name] for k in ("forward", "gradients")})
        by_path["calibration"] = calibration["launches"][name]
        by_path[f"{mesh['config']} mesh (1, 1)"] = mesh["launches"][name]
        by_path.update({f"{c} mesh (1, 1)": r["launches"][name] for c, r in mesh_archs.items()})
        by_path.update({f"{c} serving mesh (1, 1)": r["launches"][name]
                        for c, r in serve_mesh.items()})
        by_path["train launcher"] = train_launcher["launches"][name]
        by_path[f"{grads['config']} gradients"] = grads["launches"][name]
        by_path.update({f"{ex} example": examples[ex]["launches"][name] for ex in examples})
        by_path[f"{dry['arch']} dry-run check step"] = dry["launches"][name]
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": sum(by_path.values()),
                 "launches_by_path": by_path, **{k: kern[name][k] for k in keys},
                 "card": card}
        for x in extra.get(name, ()):
            entry[extra_key[x]] = {k: kern[f"{name}_{x}"][k] for k in keys}
        if name in ("ssd_scan", "ssd_scan_bwd", "flash_attention_bwd"):
            entry["stages_ms"] = kern[name]["stages_ms"]
        kernels_line["kernels"].append(entry)
    record = {"card": card, "kernels": kern, "serve": serve, "small_model": small,
              "small_train": small_train, "train": train, "train_launcher": train_launcher,
              "grads": grads, "examples": examples, "dora": dora,
              "calibration": calibration, "mesh": mesh, "mesh_archs": mesh_archs,
              "serve_mesh": serve_mesh, "dryrun": dry,
              "ptxas": ptxas, "phase_s": phase_s,
              "seconds": time.perf_counter() - t_start}
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(card, f"chip_smoke finished in {record['seconds']:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
