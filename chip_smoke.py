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
   granite-20b's 48 query heads on one KV head, mamba2-780m's SSD scan
   with each of its four bf16 stages timed by the profiler,
   recurrentgemma-9b's RG-LRU scan) plus ragged, windowed, grouped,
   empty-split and float32 cases, each error printed beside its bound
   (see ``check``), with times of the kernel, the plain version and,
   where one PyTorch call computes the same function, that call as a
   yardstick, timed in turns with the kernel (``paired_ms``; decode with
   L2 flushed before each launch); the flash backward (dq, dk, dv) at
   qwen3-32b's training shape (B=2, S=4096), h2o-danube-1.8b's (B=2,
   S=8192, head_dim 80, window 4096) and granite-20b's group (G = 48),
   and at head_dim 64, G = 1, a 2048 window, ragged S, the query group
   split across blocks (G = 48, one key tile) and float32, each of its
   three kernels (dsum, the wgmma kernel, the convert) timed by the
   profiler, with its split plan and block count, against
   scaled_dot_product_attention's backward; the flash forward and
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
   scan forward);
3. four serving paths, each at full width, bf16, batch 4, with launch
   counters (zeroed just before the path runs, read just after) showing
   its kernels ran on every layer, a profiler window (device time by
   kernel, busy share) over one prefill and three decode steps, and a
   check at batch 1 that decode steps agree with a fresh prefill:
   qwen3-32b (depth cut to 8 layers; prefill 4096, 32 decode steps),
   mamba2-780m (all 48 layers; prefill 4096, 32 steps) and
   recurrentgemma-9b (all 38 layers; prefill 2048, 32 steps, the
   2048-slot local-attention ring wrapping from the first step) and
   h2o-danube-1.8b (all 24 layers, head_dim 80; prefill 4096, 32 steps,
   the 4096-slot window ring wrapping from the first step);
4. small float32 models of four families on the card against the same
   models on the CPU, the recurrentgemma and h2o (head_dim 80) ones
   decoding past their windows so the rings wrap on both devices; and a
   float32 train step of a small qwen3-family model (head_dim 64) and of a
   small h2o-family model (head_dim 80, a window below S), each with
   attn_chunk 64 < S = 256 so the flash forward and backward kernels run,
   and of the reduced mamba2 (S = 128, chunk 32: the SSD scan's forward
   and backward kernels), on the card against the CPU: loss, grad norm and
   every gradient;
5. training through ``make_train_step`` and ``TokenPipeline`` (bf16,
   remat="full", 10 steps each): qwen3-32b at full width (depth cut to 4
   layers, batch 2 x 4096), then h2o-danube-1.8b at full width and depth
   (24 layers, batch 2 x 8192, above its 4096 window), then mamba2-780m at
   full width and depth (48 layers, batch 4 x 4096): each step's loss
   (the last below the first), its launches checked exactly (two forwards
   of the layer's kernel a layer, forward and recompute, and one
   backward), the median
   step time, tokens/s, the model-FLOP share of 989 TFLOP/s, peak memory,
   a profiler window over one step with the flash forward's and
   backward's shares; after qwen3's steps a Checkpointer round trip of the
   trained parameters and AdamW state, restored onto the card bit for
   bit;
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
   leaf's max); a small float32 h2o-family
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
   line.

The h2o paths draw wq and wk at the fan-in of d_model (``fan_in_qk``):
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

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

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
# mamba2-780m's training path: all 48 layers, batch 4 x 4096, bf16
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 4, 4096
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
             "d80 main path": "flash_attention_d80", "G=48 main path": "flash_attention_g48"}

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
                      ("flash_attention_g48", "granite-20b's G=48 prefill shape")):
        r = rec[key]
        log(card, f"flash_attention at {what}: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, scaled_dot_product_attention "
                  f"{r['library_ms']:.3f} ms (medians of turns), bound {r['bound_ms']:.3f} ms "
                  f"({r['bound_by']})")
    torch.cuda.empty_cache()


def kernels_decode(kp: KernelPhase) -> None:
    """decode_attention at qwen3-32b's, recurrentgemma-9b's,
    h2o-danube-1.8b's (head_dim 80) and granite-20b's (G = 48) decode shapes,
    and phase 7's calibration shapes (head_dim 64 and 16)."""
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
        ("d16 bf16 window", (3, 300, Hc, KVc, Dc), [300, 101, 7], 96, "bfloat16")])
    # granite-20b's group: 48 query heads on one KV head of 128
    run_decode("decode_attention_g48", "G=48 main path", [
        ("G=48 main path", (BATCH, T, G48_HEADS, 1, D), [T] * BATCH, None, "bfloat16"),
        ("G=48 f32", (2, T, G48_HEADS, 1, D), [T, 17], None, "float32")])
    del flush
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


def kernels_rglru(kp: KernelPhase) -> None:
    """rglru_scan at recurrentgemma-9b's prefill shape, a small one, ragged,
    phase 7's calibration shape."""
    from repro_torch import kernels
    from repro_torch.calibrate import microbench as mb
    from repro_torch.kernels import ref
    torch, card, rec, cases_out, rand, launched, _ = kp.unpack()

    # inputs as tests/test_kernels.py draws them: a_log = -0.5 |N(0, 1)|, b ~ N(0, 1);
    # the last is phase 7's calibration, kernel_rates' shape
    for name, (B, S, W) in [("main path", (BATCH, RG_PROMPT, RG_WIDTH)),
                            ("S 256 W 512", (2, 256, 512)), ("ragged", (3, 77, 96)),
                            ("calibration rate", mb.RGLRU_SHAPE)]:
        a = -rand((B, S, W), torch.float32).abs() * 0.5
        b = rand((B, S, W), torch.float32)
        hh, hl = launched(kernels.rglru_scan, lambda: kernels.rglru_scan.rglru_scan(a, b))
        he, hle = ref.rglru_scan_ref(a, b)
        err, share = check(torch, hh, he, "float32")
        err_l, share_l = check(torch, hl, hle, "float32")
        cases_out.append(dict(kernel="rglru_scan", case=name, dtype="float32",
                              max_abs_err=max(err, err_l), bound_share=max(share, share_l),
                              tol=TOL["float32"]))
        log(card, f"rglru_scan {name}: B={B} S={S} W={W} float32: h max abs err {err:.3e}, "
                  f"worst element at {share:.3f} of its bound, h_last {err_l:.3e} / "
                  f"{share_l:.3f} ({TOL['float32']})")
        if name == "main path":
            nbytes = 4 * (3 * B * S * W + B * W)
            # the TPU kernel's work per element: exp, ceil(log2 bt) doubling rounds of
            # 3 operations, and the carried state's 2
            ops_n = float(B * S * W * (3 * math.ceil(math.log2(min(256, S))) + 3))
            bound_ms, bound_by = bound(ops_n, nbytes, "float32")
            ms = cuda_ms(torch, lambda: kernels.rglru_scan.rglru_scan(a, b), reps=20, warmup=3)
            plain_ms = cuda_ms(torch, lambda: ref.rglru_scan_ref(a, b), reps=3)
            rec["rglru_scan"] = dict(
                shape=dict(B=B, S=S, W=W, dtype="float32"), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by, ops=ops_n,
                bytes=nbytes, max_abs_err=max(err, err_l), bound_share=max(share, share_l),
                tol=TOL["float32"])
        del a, b, hh, hl, he, hle
    r = rec["rglru_scan"]
    log(card, f"rglru_scan at the main path's shape: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, no single PyTorch call computes it, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
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
     "float32")]
# the cases timed against their bound and the library, by record key
BWD_MAINS = {"train path": "flash_attention_bwd", "d80 train path": "flash_attention_bwd_d80",
             "G=48": "flash_attention_bwd_g48"}


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
    """flash_attention_bwd at qwen3-32b's and h2o-danube-1.8b's training
    shapes, head_dim 64 and 80, G = 1, 8 and 48, windows at S = 4096 and
    8192, ragged S, float32, h2o-danube-1.8b's pipeline microbatch in bf16
    and float32; each against its plain version on the same
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
            n_split = mod.bwd_split_plan(B, S, kv, h // kv)
            blocks = -(-S // mod.BWD_KEY_TILE) * kv * B * n_split
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
    for run in (kernels_flash, kernels_flash_bwd, kernels_decode, kernels_ssd, kernels_ssd_bwd,
                kernels_rglru):
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


def decode_vs_prefill(torch, model, params, prefix, extra) -> dict:
    """Prefill ``prefix`` (1, p0), then decode the argmax token and ``extra``
    one step at a time, against one prefill over all of them: the last
    position's logits, as relative L2 and max abs error and both argmaxes."""
    p0, n = prefix.shape[1], extra.shape[1] + 1
    with torch.no_grad():
        c1 = model.init_cache(1, p0 + n + 1)
        logits_p, c1 = model.prefill(params, prefix, c1)
        fed = torch.cat([torch.argmax(logits_p, dim=-1).to(torch.int32), extra], dim=1)
        for i in range(n):
            logits_d, c1 = model.decode(params, fed[:, i:i + 1], c1,
                                        torch.full((1,), p0 + i, dtype=torch.int32,
                                                   device=prefix.device))
        del c1
        c2 = model.init_cache(1, p0 + n + 1)
        logits_f, _ = model.prefill(params, torch.cat([prefix, fed], dim=1), c2)
        del c2
    v = model.cfg.vocab_size
    a, b = logits_d[0, -1, :v].float(), logits_f[0, -1, :v].float()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError("logits are not finite")
    return dict(rel_l2=float((a - b).norm() / b.norm()), max_abs_err=float((a - b).abs().max()),
                argmax=[int(a.argmax()), int(b.argmax())])


def phase_serve(torch, card: str, path: ServePath) -> dict:
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

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
              f"{cfg.window}, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
              f"{cfg.dtype}), {cfg.n_layers} of {full.n_layers} layers: {n_params / 1e9:.3f} B "
              f"parameters summed from the tensors ({n_bytes / 1e9:.2f} GB), "
              f"ArchConfig.param_count() {analytic / 1e9:.3f} B")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, prompt)),
                             dtype=torch.int32, device=DEVICE)
    cache = model.init_cache(BATCH, prompt + GEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # warm-up on a separate cache so the timed run excludes first-call costs
    warm = model.init_cache(1, path.warm_len + 8)
    tok_w, warm = prefill_step(params, tokens[:1, :path.warm_len], warm)
    serve_step(params, tok_w, warm, torch.full((1,), path.warm_len, dtype=torch.int32,
                                               device=DEVICE))
    del warm
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    tok, cache = prefill_step(params, tokens, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = kernels.launch_counts()
    generated, lat = [tok], []
    for i in range(GEN):
        pos = torch.full((BATCH,), prompt + i, dtype=torch.int32, device=DEVICE)
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
    last = torch.full((BATCH,), prompt + GEN - 1, dtype=torch.int32, device=DEVICE)
    prof = {"prefill": profile(torch, lambda: prefill_step(params, tokens, cache), card,
                               f"one {cfg.name} prefill ({BATCH}x{prompt})"),
            "decode": profile(torch, lambda: [serve_step(params, tok, cache, last)
                                              for _ in range(3)], card,
                              f"three {cfg.name} decode steps")}
    del cache

    lat_a = np.array(lat)
    p50, p99 = float(np.percentile(lat_a, 50)), float(np.percentile(lat_a, 99))
    tok_s = BATCH * GEN / (lat_a.sum() / 1e3)
    log(card, f"{cfg.name} prefill {BATCH}x{prompt} tokens: {prefill_ms:.1f} ms "
              f"({BATCH * prompt / prefill_ms * 1e3:.0f} tokens/s)")
    log(card, f"{cfg.name} decode {GEN} steps at batch {BATCH}: p50 {p50:.2f} ms p99 "
              f"{p99:.2f} ms per token step, {tok_s:.1f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(card, f"{cfg.name} launches: prefill {after_prefill}, prefill + {GEN} decode steps "
              f"{counts}")

    # decode steps vs one fresh prefill over the same tokens, at batch 1
    p0, n = path.check_prefix, path.check_steps
    extra = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n - 1)), dtype=torch.int32,
                            device=DEVICE)
    check = {}
    served = decode_vs_prefill(torch, model, params, tokens[:1, :p0], extra)
    if path.qk_fan_in:      # the same check with the reference init's wq and wk
        check["reference_init"] = decode_vs_prefill(torch, model, params_ref, tokens[:1, :p0],
                                                    extra)
        log(card, f"{cfg.name} decode vs fresh prefill with the reference init's wq and wk "
                  f"(fan-in read from the head axis; without qk-norm the attention is a hard "
                  f"max and the random model chaotic): relative L2 "
                  f"{check['reference_init']['rel_l2']:.3e}, argmax "
                  f"{check['reference_init']['argmax']} (reported, not checked)")
    del params_ref
    if path.check_dtype == cfg.dtype:
        check = served
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
        # how far a 1e-7 relative change of the embedding moves the last logits
        seq = torch.cat([tokens[:1, :p0], extra[:, :1], extra], dim=1)[:, :p0 + n]
        with torch.no_grad():
            base = model.prefill(params, seq, model.init_cache(1, p0 + n + 1))[0]
            embed = params["embed"]
            params["embed"] = embed * (1 + 1e-7 * torch.randn(
                embed.shape, generator=torch.Generator(device=DEVICE).manual_seed(1),
                device=DEVICE))
            moved = model.prefill(params, seq, model.init_cache(1, p0 + n + 1))[0]
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
        check.update(decode_vs_prefill(torch, model, params, tokens[:1, :p0], extra))
    rel = check["rel_l2"]
    consistency_tol = 3e-2
    log(card, f"{cfg.name} decode vs fresh prefill at batch 1, {cfg.dtype} weights, "
              f"{cfg.n_layers} layers: prefill {p0}, {n} decode step(s), against one prefill "
              f"of {p0 + n}: relative L2 error {rel:.3e} (tol {consistency_tol}), max abs err "
              f"{check['max_abs_err']:.3e}, argmax {check['argmax']}")
    if rel > consistency_tol:
        raise AssertionError("decode steps disagree with a fresh prefill")
    check.update(prefix=p0, steps=n, dtype=cfg.dtype, n_layers=cfg.n_layers,
                 served_rel_l2=served["rel_l2"])
    return dict(config=full.name, n_layers=path.layers or full.n_layers,
                full_layers=full.n_layers,
                params=n_params, params_b=n_params / 1e9, param_bytes=n_bytes,
                param_count_analytic_b=analytic / 1e9, batch=BATCH, prompt=prompt,
                gen=GEN, prefill_ms=prefill_ms, decode_p50_ms=p50, decode_p99_ms=p99,
                decode_tokens_s=tok_s, peak_bytes=peak, launches=counts,
                launches_prefill=after_prefill, consistency_rel_l2=rel, consistency=check,
                decode_ms=lat, profile=prof)


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
]
# (arch, overrides, S, wq and wk at the fan-in of d_model) of the small float32
# train steps, card against CPU: attn_chunk 64 < S, so the flash forward and
# backward kernels run; the reduced mamba2 (4 layers, chunk 32) at S = 128 runs
# the SSD scan's forward and backward kernels
SMALL_TRAIN = [
    ("qwen3_32b", dict(head_dim=64, attn_chunk=64), 256, False),
    # head_dim 80, and a window below S that binds in both kernels
    ("h2o_danube_1_8b", dict(head_dim=80, n_layers=2, attn_chunk=64, window=96), 256, True),
    ("mamba2_780m", {}, 128, False),
]


def train_launches(cfg) -> Dict[str, int]:
    """The kernel launches of one train step with remat="full": each layer's
    kernel runs forward twice (forward and recompute) and backward once."""
    fwd, bwd = ("ssd_scan", "ssd_scan_bwd") if cfg.ssm else ("flash_attention",
                                                             "flash_attention_bwd")
    return {fwd: 2 * cfg.n_layers, bwd: cfg.n_layers}


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
    sqrt(heads / d_model) (``params`` itself when ``on`` is false)."""
    if not on:
        return params
    scale = (cfg.n_heads / cfg.d_model) ** 0.5
    out = dict(params)
    for group in ("stack", "tail"):
        if group in params:
            out[group] = {u: dict(block, mixer={k: (w * scale if k in ("wq", "wk") else w)
                                                for k, w in block["mixer"].items()})
                          for u, block in params[group].items()}
    return out


def _nudged(torch, params):
    """``params`` (on the CPU) with the embedding changed by 1e-7 relative:
    how far that moves a result on the CPU alone is the conditioning of a
    card-vs-CPU check of it."""
    e = params["embed"]
    noise = torch.randn(e.shape, generator=torch.Generator().manual_seed(3))
    return dict(params, embed=e * (1 + 1e-7 * noise))


def _serve_logits(torch, model, params, toks, prompt: int, steps: int) -> list:
    """The logits of a prefill of ``prompt`` tokens and ``steps`` decode steps."""
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
    return out


def phase_small_model(torch, card: str, arch: str, overrides: dict, prompt: int, steps: int,
                      want: Dict[str, int], qk_fan_in: bool = False) -> dict:
    """A small float32 model on the card against the same weights on the
    CPU, where the plain versions run; the check's conditioning (how far a
    1e-7 change of the embedding moves the CPU's logits) printed beside it."""
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
    want_l = _serve_logits(torch, cpu, params, toks, prompt, steps)
    got_l = _serve_logits(torch, gpu, _to(params, DEVICE), toks, prompt, steps)
    counts = kernels.launch_counts()
    if counts != {k: want.get(k, 0) for k in kernels.KERNELS}:
        raise AssertionError(f"small {arch} launches {counts}, expected {want}")
    err = max(float((a - b).abs().max()) for a, b in zip(got_l, want_l))
    nudged = _serve_logits(torch, cpu, _nudged(torch, params), toks, prompt, steps)
    cond = max(float((a - b).abs().max()) for a, b in zip(nudged, want_l))
    tol = 1e-4
    log(card, f"small f32 {cfg.name} ({cfg.n_layers} layers, {overrides}, wq/wk fan-in "
              f"{'d_model' if qk_fan_in else 'heads'}) "
              f"card vs CPU: max abs logit err {err:.3e} (tol {tol}) over prefill {prompt} + "
              f"{steps} decode steps; a 1e-7 change of the embedding moves the CPU's logits by "
              f"{cond:.3e}; launches {counts}")
    if err > tol:
        raise AssertionError("the card disagrees with the CPU on a small model")
    return dict(arch=arch, max_abs_err=err, tol=tol, conditioning=cond, qk_fan_in=qk_fan_in,
                launches=counts)


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
    and backward kernels run (for mamba2 the SSD scan's): loss and grad_norm
    within 1e-4 relative,
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
    want.update(train_launches(cfg))
    if out[DEVICE]["launches"] != want:
        raise AssertionError(f"small train step launches {out[DEVICE]['launches']}, "
                             f"expected {want}")
    step_err = {k: abs(float(out[DEVICE][k]) - float(out["cpu"][k])) / abs(float(out["cpu"][k]))
                for k in ("loss", "grad_norm")}
    log(card, f"small f32 {cfg.name} ({cfg.n_layers} layers, {overrides}, wq/wk fan-in "
              f"{'d_model' if qk_fan_in else 'heads'}, "
              f"S={S}) train step, card vs CPU: loss rel err {loss_err:.3e}; a 1e-7 change of "
              f"the embedding moves the CPU's gradients by up to {cond:.3e} of a leaf's max; "
              f"worst gradient "
              f"{grad_err:.3e} of its leaf's max, train-step loss {step_err['loss']:.3e} and "
              f"grad_norm {step_err['grad_norm']:.3e} relative (tol {tol}); launches "
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
    products: the layers' projections and MLP and the head; the embedding is
    a lookup) x tokens, plus attention's scores and P V (4 d operations a
    live pair and head) three times (forward and backward); for an SSM
    (mamba2) the layers' in and out projections and the SSD scan's linear
    form (``kernels/flops.ssd_scan_flops``) three times; the recomputation
    of remat="full" is not counted."""
    if cfg.ssm:
        from repro_torch.kernels import flops
        d, din, gn, nh = cfg.d_model, cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, \
            cfg.ssm_nheads
        per_layer = d * (2 * din + 2 * gn + nh) + din * d
        ssd = flops.ssd_scan_flops(batch, seq, nh, cfg.ssm_headdim, cfg.ssm_ngroups,
                                   cfg.ssm_state)
        return 6.0 * (cfg.n_layers * per_layer + d * cfg.padded_vocab) * batch * seq \
            + 3 * ssd * cfg.n_layers
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = 2 * d * h * hd + 2 * d * kv * hd + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    matmul = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attn = 3 * 4 * hd * h * batch * live_pairs(seq, seq, True, cfg.window) * cfg.n_layers
    return 6.0 * matmul * batch * seq + attn


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


TRAIN_PATHS = [
    TrainPath("qwen3_32b", TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, True),
    # full depth; S = 8192 above the 4096 window, which binds in both kernels;
    # wq and wk at the fan-in of d_model (the reference init's first grad norm
    # is printed beside the run)
    TrainPath("h2o_danube_1_8b", None, H2O_TRAIN_BATCH, H2O_TRAIN_SEQ, TRAIN_STEPS, False,
              True),
    # all 48 SSD layers: the ssd_scan forward and backward kernels
    TrainPath("mamba2_780m", None, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, TRAIN_STEPS, False),
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
    width = (f"{cfg.ssm_nheads} SSD heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk}" if cfg.ssm else f"{cfg.n_heads} heads on {cfg.n_kv_heads} KV "
             f"heads of {cfg.hd}, d_ff {cfg.d_ff}")
    log(card, f"training {cfg.name} at full width (d_model {cfg.d_model}, {width}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}), {cfg.n_layers} of {full.n_layers} layers: "
              f"{n_params / 1e9:.3f} B "
              f"parameters, {state_bytes / 1e9:.2f} GB with the AdamW state; batch {B} x {S}, "
              f"window {cfg.window}, remat='full', {steps} steps, peak lr 3e-4, warmup 2, wq/wk "
              f"fan-in {'d_model' if path.qk_fan_in else 'heads (the reference init)'}")
    per_step = {k: 0 for k in kernels.KERNELS}
    per_step.update(train_launches(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, step_ms, metrics = [], [], []
    for step in range(steps):
        batch = next(data)
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
                  f"{m['lr']:.3e}, {step_ms[-1]:.1f} ms")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
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
    batch = next(data)
    groups = {"ssd_scan forward": ("ssd_cb_", "ssd_chunk_state_", "ssd_state_passing_",
                                   "ssd_chunk_scan_"), "ssd_scan backward": "ssd_bwd_"} \
        if cfg.ssm else {"flash_attention forward": "flash_wgmma_kernel",
                         "flash_attention backward": "flash_bwd_"}
    prof = profile(torch, lambda: train_step(params, opt, batch, steps), card,
                   f"one {cfg.name} train step ({B}x{S})", groups=groups)
    data.close()
    del batch
    out = dict(config=full.name, n_layers=cfg.n_layers, full_layers=full.n_layers,
               params=n_params, state_bytes=state_bytes, batch=B, seq=S, window=cfg.window,
               steps=steps, losses=losses, metrics=metrics, step_ms=step_ms, step_ms_median=med,
               tokens_s=tok_s, model_flops=flops, mfu=mfu, peak_bytes=peak, launches=counts,
               launches_per_step=per_step, profile=prof, alloc_retries=retries,
               reserved_peak_bytes=reserved)

    if path.checkpoint:
        out["checkpoint"] = checkpoint_round_trip(torch, card, cfg.name, steps, params, opt)

    # the optimizer's share of a step: one AdamW update of the trained state alone
    from repro_torch.optim import adamw_update
    grads = _fill_like(params, 1e-3)
    out["profile_adamw"] = profile(torch, lambda: adamw_update(grads, opt, params, 1e-5), card,
                                   f"one AdamW update of the {n_params / 1e9:.3f} B parameters")
    del grads
    if path.qk_fan_in:      # the first batch's gradient with the reference init's wq and wk
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                        seed=0), device=DEVICE)
        batch = next(data)
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


def phase_pipeline_forward(torch, card: str, planned: dict) -> dict:
    """The forward plan's model at full width and depth through the
    executor on the card (bf16, no grad), held against the same layers
    applied microbatch by microbatch in plain order; launches exact."""
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


def phase_pipeline_grads(torch, card: str, planned: dict) -> dict:
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
    ``LM.loss``'s."""
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
    for name, fn in (("forward", lambda: phase_pipeline_forward(torch, card, planned["forward"])),
                     ("gradients",
                      lambda: phase_pipeline_grads(torch, card, planned["gradients"])),
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
            "ssd_scan_bwd": step * lm, "rglru_scan": rate}


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
    names = ["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
             "ssd_scan_bwd", "rglru_scan"]
    logs = _build.build(names)
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
    if len(hgmma) != 3 or not all(hgmma.values()):
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
        serve[path.arch] = phase_serve(torch, card, path)
        gc.collect()
        torch.cuda.empty_cache()
    timed("3 serving", t0)
    t0 = time.perf_counter()
    small = [phase_small_model(torch, card, *spec) for spec in SMALL]   # phase 4
    small_train = [phase_small_train(torch, card, *spec) for spec in SMALL_TRAIN]
    timed("4 small models", t0)
    t0 = time.perf_counter()
    train = {}
    for tpath in TRAIN_PATHS:                # phase 5
        gc.collect()
        torch.cuda.empty_cache()
        train[tpath.arch] = phase_train(torch, card, tpath)
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
                              "src/repro/kernels/rglru_scan.py:34")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "bound_share", "tol", "shape")
    kernels_line = {"kernels": []}
    # the main entry is each kernel's qwen3-32b (or only) shape; the other
    # timed shapes ride beside it, each with the same keys
    extra = {"flash_attention": ("d256", "d80", "g48"),
             "decode_attention": ("d256", "d80", "g48", "d16"),
             "flash_attention_bwd": ("d80", "g48")}
    extra_key = {"d256": "head_dim_256", "d80": "head_dim_80", "g48": "group_48",
                 "d16": "head_dim_16"}
    for name in names:
        by_path = {arch: r["launches"][name] for arch, r in serve.items()}
        by_path.update({f"{arch} train": r["launches"][name] for arch, r in train.items()})
        by_path.update({f"{dora[k]['arch']} {label}": dora[k]["launches"][name]
                        for k, label in (("forward", "pipeline forward"),
                                         ("gradients", "pipeline gradients"),
                                         ("launcher", "planning launcher"),
                                         ("catalogue_launcher", f"{CATALOGUE} launcher"),
                                         ("catalogue_replan",
                                          f"{CATALOGUE} replanned pipeline forward"))})
        by_path["calibration"] = calibration["launches"][name]
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
              "small_train": small_train, "train": train, "dora": dora,
              "calibration": calibration, "ptxas": ptxas, "phase_s": phase_s,
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
