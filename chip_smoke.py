#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/ and runs four phases:

1. the device: name and power limit from nvidia-smi;
2. each kernel against its plain PyTorch version at the serving path's
   shapes (bf16, qwen3-32b heads) plus ragged, windowed and float32 cases,
   each error printed beside its bound (see ``check``), with times of the
   kernel, the plain version and one PyTorch library call as a yardstick;
3. the serving path: qwen3-32b at full width, depth cut to 8 layers, bf16,
   batch 4: prefill of 4096 tokens, then 32 greedy decode steps, with
   launch counters showing both kernels ran on every layer, a profiler
   window (device time by kernel, busy share) over one prefill and three
   decode steps, and a check that a decode step agrees with a fresh
   prefill at batch 1;
4. a small float32 model on the card against the same model on the CPU.

Every number printed carries the card's name and power limit. The
second-to-last line is the kernels record (JSON); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; without a CUDA device, or without the repository beside
it, the script exits non-zero at once. The full record is also written to
build/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and op/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# the serving path's shapes: qwen3-32b, batch 4, prompt 4096, 32 decode steps
DEVICE = "cuda"
BATCH, PROMPT, GEN, LAYERS = 4, 4096, 32, 8
HEADS, KV_HEADS, HEAD_DIM = 64, 8, 128
ARCH = "qwen3_32b"


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


def check(torch, out, exp, dt: str):
    """Max abs error of ``out`` against ``exp`` and the largest share of its
    bound that any element uses (over 1 means a failure)."""
    out, exp = out.float(), exp.float()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("kernel output is not finite")
    err = (out - exp).abs()
    if dt == "bfloat16":
        row_rms = exp.pow(2).mean(dim=-1, keepdim=True).sqrt()
        bound = BF16_RTOL * (exp.abs() + row_rms)
    else:
        bound = F32_TOL + F32_TOL * exp.abs()
    share = float((err / bound).nan_to_num(nan=0.0, posinf=float("inf")).max())
    if share > 1.0:
        raise AssertionError(f"kernel disagrees with its plain version: max abs err "
                             f"{float(err.max()):.3e}, {share:.3g} x its bound ({TOL[dt]})")
    return float(err.max()), share


TOL = {"bfloat16": "|err| <= 2**-5 (|ref| + rms_row(ref)) against float32 plain",
       "float32": "|err| <= 2e-5 + 2e-5 |ref|"}


def phase_kernels(torch, card: str) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    H, KV, D = HEADS, KV_HEADS, HEAD_DIM
    rec, cases = {}, []

    # -- flash attention -------------------------------------------------------
    for name, (B, S, T, h, kv, d), causal, window, dt in [
            ("main path", (BATCH, PROMPT, PROMPT, H, KV, D), True, None, "bfloat16"),
            ("ragged S", (1, PROMPT + 1, PROMPT + 1, H, KV, D), True, None, "bfloat16"),
            ("window", (1, PROMPT // 2, PROMPT // 2, H, KV, D), True, PROMPT // 4, "bfloat16"),
            ("ragged short", (2, 200, 200, 8, 2, D), True, None, "bfloat16"),
            ("non-causal ragged d64", (2, 300, 777, 8, 2, 64), False, None, "bfloat16"),
            ("f32 causal", (1, PROMPT // 4, PROMPT // 4, H, KV, D), True, None, "float32"),
            ("f32 non-causal ragged d64", (2, 300, 777, 8, 2, 64), False, None, "float32")]:
        q, k, v = rand((B, S, h, d), dtypes[dt]), rand((B, T, kv, d), dtypes[dt]), \
            rand((B, T, kv, d), dtypes[dt])
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()

        def plain(q=q, k=k, v=v):  # a batch row at a time: all rows' (S, T) scores do not fit
            return torch.cat([ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                      causal=causal, window=window)
                              for i in range(B)])
        exp = plain(q.float(), k.float(), v.float())
        err, share = check(torch, out, exp, dt)
        cases.append(dict(kernel="flash_attention", case=name, dtype=dt, max_abs_err=err,
                          bound_share=share, tol=TOL[dt]))
        log(card, f"flash_attention {name}: B={B} S={S} T={T} H={h} KV={kv} d={d} {dt} "
                  f"window={window} causal={causal}: max abs err {err:.3e}, worst element "
                  f"at {share:.3f} of its bound ({TOL[dt]})")
        if name == "main path":
            live = S * (S + 1) // 2                      # causal pairs per (b, h)
            ops_n = 4.0 * B * h * d * live               # QK^T and PV, 2 ops per MAC
            nbytes = 2 * (2 * B * S * h * d + 2 * B * T * kv * d)
            bound_ms, bound_by = bound(ops_n, nbytes, dt)
            ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True), reps=5)
            plain_ms = cuda_ms(torch, plain, reps=2)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
            rec["flash_attention"] = dict(
                shape=dict(B=B, S=S, T=T, H=h, KV=kv, d=d, dtype=dt, causal=True),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops_n, bytes=nbytes, max_abs_err=err,
                bound_share=share, tol=TOL[dt])
        del q, k, v, out, exp
    r = rec["flash_attention"]
    log(card, f"flash_attention at the main path's shape: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, scaled_dot_product_attention "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")

    # -- decode attention ------------------------------------------------------
    T = PROMPT + GEN
    for name, (B, t, h, kv, d), lens, window, dt in [
            ("main path", (BATCH, T, H, KV, D), [T] * BATCH, None, "bfloat16"),
            ("per-batch lengths", (4, T, H, KV, D), [T, PROMPT + 1, PROMPT // 4, 1], None,
             "bfloat16"),
            ("window", (4, T, H, KV, D), [T, 3 * T // 4, T // 8, 17], T // 4, "bfloat16"),
            ("T=300 MQA d64", (3, 300, 8, 1, 64), [300, 101, 7], 96, "bfloat16"),
            ("f32", (2, T, H, KV, D), [T, PROMPT // 2 + 1], None, "float32"),
            ("f32 T=300 MQA d64", (3, 300, 8, 1, 64), [300, 101, 7], 96, "float32")]:
        q = rand((B, 1, h, d), dtypes[dt])
        kc, vc = rand((B, t, kv, d), dtypes[dt]), rand((B, t, kv, d), dtypes[dt])
        cl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        out = ops.decode_attention(q, kc, vc, cl, window=window)
        torch.cuda.synchronize()
        exp = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), cl, window=window)
        err, share = check(torch, out, exp, dt)
        cases.append(dict(kernel="decode_attention", case=name, dtype=dt, max_abs_err=err,
                          bound_share=share, tol=TOL[dt]))
        log(card, f"decode_attention {name}: B={B} T={t} H={h} KV={kv} d={d} {dt} "
                  f"lens={lens} window={window}: max abs err {err:.3e}, worst element "
                  f"at {share:.3f} of its bound ({TOL[dt]})")
        if name == "main path":
            live = sum(min(n, t) for n in lens)          # cache rows the lengths make live
            elt = 2
            nbytes = elt * (2 * live * kv * d + 2 * B * h * d) + 4 * B
            ops_n = 4.0 * h * d * live
            bound_ms, bound_by = bound(ops_n, nbytes, dt)
            ms = cuda_ms(torch, lambda: ops.decode_attention(q, kc, vc, cl), reps=50, warmup=3)
            plain_ms = cuda_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, cl), reps=20)
            mask = (torch.arange(t, device=DEVICE)[None, :] < cl[:, None])[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=20)
            rec["decode_attention"] = dict(
                shape=dict(B=B, T=t, H=h, KV=kv, d=d, dtype=dt, cache_len=lens),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops_n, bytes=nbytes, max_abs_err=err,
                bound_share=share, tol=TOL[dt])
        del q, kc, vc, out, exp
    r = rec["decode_attention"]
    log(card, f"decode_attention at the main path's shape: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    rec["cases"] = cases
    return rec


def profile(torch, fn, card: str, what: str) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    rows = [dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count)
            for e in top]
    log(card, f"profile of {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in dev)} kernel launches")
    for row in rows:
        log(card, f"  {row['ms']:9.3f} ms {row['calls']:5d}x  {row['kernel']}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, top=rows)


def phase_serve(torch, card: str) -> dict:
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    full = get_config(ARCH)
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    log(card, f"serving {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
              f"{cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.dtype}); depth cut "
              f"n_layers {full.n_layers} -> {cfg.n_layers}: {cfg.param_count() / 1e9:.2f} B "
              f"parameters")
    model, prefill_step = make_prefill_step(cfg, device=DEVICE)
    _, serve_step = make_serve_step(cfg, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                             dtype=torch.int32, device=DEVICE)
    cache = model.init_cache(BATCH, PROMPT + GEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # warm-up on a separate cache so the timed run excludes first-call costs
    warm = model.init_cache(1, 2 * cfg.attn_chunk + 8)
    tok_w, warm = prefill_step(params, tokens[:1, :2 * cfg.attn_chunk + 1], warm)
    serve_step(params, tok_w, warm, torch.full((1,), 2 * cfg.attn_chunk + 1,
                                               dtype=torch.int32, device=DEVICE))
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
        pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device=DEVICE)
        t1 = time.perf_counter()
        tok, cache = serve_step(params, tok, cache, pos)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
        generated.append(tok)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    if after_prefill != {"flash_attention": LAYERS, "decode_attention": 0}:
        raise AssertionError(f"prefill launches {after_prefill}, expected {LAYERS} flash")
    want = {"flash_attention": LAYERS, "decode_attention": LAYERS * GEN}
    if counts != want:
        raise AssertionError(f"serving launches {counts}, expected {want}")
    gen_toks = torch.cat(generated, dim=1).cpu()
    if gen_toks.shape != (BATCH, GEN + 1) or gen_toks.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(gen_toks.shape)} {gen_toks.dtype}")
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")

    # where the time goes: one prefill and three decode steps under the profiler
    # (the decode steps rewrite the cache's last slot; the counts are already read)
    last = torch.full((BATCH,), PROMPT + GEN - 1, dtype=torch.int32, device=DEVICE)
    prof = {"prefill": profile(torch, lambda: prefill_step(params, tokens, cache), card,
                               f"one prefill ({BATCH}x{PROMPT})"),
            "decode": profile(torch, lambda: [serve_step(params, tok, cache, last)
                                              for _ in range(3)], card, "three decode steps")}

    lat_a = np.array(lat)
    p50, p99 = float(np.percentile(lat_a, 50)), float(np.percentile(lat_a, 99))
    tok_s = BATCH * GEN / (lat_a.sum() / 1e3)
    log(card, f"prefill {BATCH}x{PROMPT} tokens: {prefill_ms:.1f} ms "
              f"({BATCH * PROMPT / prefill_ms * 1e3:.0f} tokens/s)")
    log(card, f"decode {GEN} steps at batch {BATCH}: p50 {p50:.2f} ms p99 {p99:.2f} ms "
              f"per token step, {tok_s:.1f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(card, f"launches: prefill {after_prefill}, prefill + {GEN} decode steps {counts}")

    # decode step vs a fresh prefill over prompt + token, at batch 1; the
    # decode kernel produces the one, the flash kernel (S = 4097) the other
    with torch.no_grad():
        c1 = model.init_cache(1, PROMPT + 2)
        logits_p, c1 = model.prefill(params, tokens[:1], c1)
        nxt = torch.argmax(logits_p, dim=-1).to(torch.int32)
        logits_d, _ = model.decode(params, nxt, c1,
                                   torch.full((1,), PROMPT, dtype=torch.int32, device=DEVICE))
        c2 = model.init_cache(1, PROMPT + 2)
        logits_f, _ = model.prefill(params, torch.cat([tokens[:1], nxt], dim=1), c2)
    v = cfg.vocab_size
    a, b = logits_d[0, -1, :v].float(), logits_f[0, -1, :v].float()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError("logits are not finite")
    rel = float((a - b).norm() / b.norm())
    consistency_tol = 3e-2
    log(card, f"decode vs fresh prefill at position {PROMPT}, batch 1: relative L2 error "
              f"{rel:.3e} (tol {consistency_tol}), max abs err {float((a - b).abs().max()):.3e}, "
              f"argmax {int(a.argmax())} vs {int(b.argmax())}")
    if rel > consistency_tol:
        raise AssertionError("decode step disagrees with a fresh prefill")
    return dict(config=cfg.name, n_layers=cfg.n_layers, full_layers=full.n_layers,
                params_b=cfg.param_count() / 1e9, batch=BATCH, prompt=PROMPT, gen=GEN,
                prefill_ms=prefill_ms, decode_p50_ms=p50, decode_p99_ms=p99,
                decode_tokens_s=tok_s, peak_bytes=peak, launches=counts,
                launches_prefill=after_prefill, consistency_rel_l2=rel,
                decode_ms=lat, profile=prof)


def phase_small_model(torch, card: str) -> dict:
    """A small float32 model (head_dim 64, chunked prefill) on the card
    against the same weights on the CPU, where the plain versions run."""
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced_config("qwen3_32b"), head_dim=64, n_layers=2,
                              attn_chunk=64)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=DEVICE)
    params = cpu.init(torch.Generator().manual_seed(1))
    params_g = _to(params, DEVICE)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 131), generator=g, dtype=torch.int32)
    kernels.reset_launches()
    errs = []
    with torch.no_grad():
        c_cpu, c_gpu = cpu.init_cache(2, 136), gpu.init_cache(2, 136)
        lc, c_cpu = cpu.prefill(params, toks[:, :128], c_cpu)
        lg, c_gpu = gpu.prefill(params_g, toks[:, :128].to(DEVICE), c_gpu)
        errs.append(float((lg.cpu() - lc).abs().max()))
        for i in range(3):
            pos = torch.full((2,), 128 + i, dtype=torch.int32)
            lc, c_cpu = cpu.decode(params, toks[:, 128 + i:129 + i], c_cpu, pos)
            lg, c_gpu = gpu.decode(params_g, toks[:, 128 + i:129 + i].to(DEVICE), c_gpu,
                                   pos.to(DEVICE))
            errs.append(float((lg.cpu() - lc).abs().max()))
    counts = kernels.launch_counts()
    if counts != {"flash_attention": 2, "decode_attention": 6}:
        raise AssertionError(f"small model launches {counts}")
    tol = 1e-4
    log(card, f"small f32 model (2 layers, head_dim 64) card vs CPU: max abs logit err "
              f"{max(errs):.3e} (tol {tol}) over prefill + 3 decode steps")
    if max(errs) > tol:
        raise AssertionError("the card disagrees with the CPU on a small model")
    return dict(max_abs_err=max(errs), tol=tol)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    names = ["flash_attention", "decode_attention"]
    logs = _build.build(names)
    log(card, f"built the kernels in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(card, f"ptxas {name}: {line.strip()[:110]}")

    kern = phase_kernels(torch, card)        # phase 2
    serve = phase_serve(torch, card)         # phase 3
    small = phase_small_model(torch, card)   # phase 4

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:35"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:30")}
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": serve["launches"][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name]["library_ms"],
         "tol": kern[name]["tol"], "bound_share": kern[name]["bound_share"],
         "shape": kern[name]["shape"], "card": card}
        for name in ("flash_attention", "decode_attention")]}
    record = {"card": card, "kernels": kern, "serve": serve, "small_model": small,
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
