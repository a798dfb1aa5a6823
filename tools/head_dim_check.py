"""Check the attention kernels' reduced head dims on one card in one run:
build the six CUDA sources, print each instance's ptxas facts (registers,
spills, shared memory, HGMMA count), then hold every instance at head_dim
16, 24 and 32 (both types) and float32 256 against its plain version at
small ragged shapes (the flash forward causal, windowed and non-causal with
S != T; the backward with windows and split groups; decode with lengths
down to 0 and a window, and its sharded-keys mode on four shards), time the
flash forward and backward at the reduced configs' widths (B = 4, S = T =
4096; float32 256 at recurrentgemma_9b's 16 heads on one KV head with its
2048 window), and serve four reduced configs through the serve launcher.

    python3 tools/head_dim_check.py [build fwd bwd decode time serve]

Tolerances are ``chip_smoke.py``'s (``check``). Prints one line a case
(OK or FAIL), then the failing cases; exits 1 if any failed.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402

def main() -> int:
    if not torch.cuda.is_available():
        print("head_dim_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    what = sys.argv[1:] or ["build", "fwd", "bwd", "decode", "time", "serve"]
    t0 = time.time()
    logs = _build.build(["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
                         "ssd_scan_bwd", "rglru_scan"])
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    for r in cs.ptxas_record(logs):
        print("ptxas", r["source"], r["function"], r.get("registers"), "regs, spill",
              r.get("spill_stores", 0), r.get("spill_loads", 0), "smem", r.get("dynamic_smem"),
              "hgmma", r.get("hgmma"), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    fails = []


    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(DT[dt])


    def hold(name, out, exp, dt, floor=0.0):
        try:
            err, share = cs.check(torch, out, exp, dt, floor)
            print(f"OK {name}: err {err:.3e} share {share:.3f}", flush=True)
        except AssertionError as e:
            print(f"FAIL {name}: {e}", flush=True)
            fails.append(name)


    if "fwd" in what:
        for dt, ds in (("bfloat16", (16, 24, 32)), ("float32", (16, 24, 32, 256))):
            for d in ds:
                for (B, S, T, H, KV), causal, window in [
                        ((2, 256, 256, 8, 2), True, None), ((1, 300, 300, 4, 1), True, 100),
                        ((2, 200, 333, 4, 4), False, None), ((1, 1000, 1000, 8, 2), True, 40),
                        ((2, 130, 130, 4, 1), True, 32)]:
                    try:
                        q = rnd((B, S, H, d), dt)
                        k, v = rnd((B, T, KV, d), dt), rnd((B, T, KV, d), dt)
                        out = ops.flash_attention(q, k, v, causal=causal, window=window)
                        torch.cuda.synchronize()
                        exp = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                      causal=causal, window=window)
                        hold(f"fwd {dt} d{d} {(B, S, T, H, KV)} c{causal} w{window}", out, exp, dt)
                    except Exception as e:
                        print(f"FAIL fwd {dt} d{d}: {type(e).__name__} {e}", flush=True)
                        fails.append(f"fwd {dt} {d}")
    if "bwd" in what:
        for dt, ds in (("bfloat16", (16, 24, 32)), ("float32", (16, 24, 32, 256))):
            for d in ds:
                for (B, S, H, KV), window in [((2, 256, 4, 4), None), ((1, 300, 8, 2), 100),
                                              ((1, 333, 8, 1), None), ((1, 1024, 16, 1), 300),
                                              ((1, 100, 8, 1), None), ((2, 130, 4, 1), 32)]:
                    try:
                        q, k, v = (rnd((B, S, n, d), dt) for n in (H, KV, KV))
                        dout = rnd((B, S, H, d), dt)
                        out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
                        exp_lse = ref.flash_attention_lse_ref(q.float(), k.float(), causal=True,
                                                              window=window)
                        lerr = float((lse - exp_lse).abs().max())
                        got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                                      window=window)
                        torch.cuda.synchronize()
                        plain = [t.float() for t in (q, k, v, out)] + [lse, dout.float()]
                        exp = ref.flash_attention_bwd_ref(*plain, causal=True, window=window)
                        split = kernels.flash_attention.bwd_split_plan(B, S, KV, H // KV, d)
                        for nm, g, e in zip(("dq", "dk", "dv"), got, exp):
                            hold(f"bwd {dt} d{d} {(B, S, H, KV)} w{window} split{split} {nm} "
                                 f"(lse err {lerr:.2e})", g, e,
                                 dt, cs.BWD_FLOOR if dt == "bfloat16" else 0.0)
                    except Exception as e:
                        print(f"FAIL bwd {dt} d{d}: {type(e).__name__} {e}", flush=True)
                        fails.append(f"bwd {dt} {d}")
    if "decode" in what:
        for dt in ("bfloat16", "float32"):
            for d in (24, 32, 16):
                for (B, T, H, KV), lens, window in [((4, 256, 4, 4), [256, 225, 17, 0], None),
                                                    ((3, 300, 4, 1), [300, 101, 7], 96),
                                                    ((4, 4128, 8, 2), [4128, 1, 0, 4127], None),
                                                    ((2, 64, 16, 1), [64, 33], 8)]:
                    try:
                        q = rnd((B, 1, H, d), dt)
                        kc, vc = rnd((B, T, KV, d), dt), rnd((B, T, KV, d), dt)
                        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
                        out = ops.decode_attention(q, kc, vc, cl, window=window)
                        torch.cuda.synchronize()
                        exp = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), cl,
                                                       window=window)
                        exp[cl == 0] = 0.0
                        hold(f"decode {dt} d{d} {(B, T, H, KV)} {lens} w{window}", out, exp, dt)
                        parts = []
                        for a in range(0, T, T // 4 + 1):
                            e_ = min(T, a + T // 4 + 1)
                            o, l = dec.decode_attention_partial(q, kc[:, a:e_], vc[:, a:e_], cl,
                                                                kv_offset=a, window=window)
                            eo, el = dec.decode_attention_partial_ref(
                                q.float(), kc[:, a:e_].float(), vc[:, a:e_].float(), cl,
                                kv_offset=a, window=window)
                            hold(f"partial {dt} d{d} [{a},{e_})", o, eo, dt)
                            hold(f"partial lse {dt} d{d} [{a},{e_})", l, el, "float32")
                    except Exception as e:
                        print(f"FAIL decode {dt} d{d}: {type(e).__name__} {e}", flush=True)
                        fails.append(f"decode {dt} {d}")
    if "time" in what:
        for dt, d, H, KV, window in (("bfloat16", 16, 8, 2, None), ("bfloat16", 24, 4, 4, None),
                                     ("bfloat16", 32, 4, 1, 32), ("float32", 16, 8, 2, None),
                                     ("float32", 24, 4, 4, None), ("float32", 32, 4, 1, 32),
                                     ("float32", 256, 16, 1, 2048)):
            B, S = 4, 4096
            q, k, v = rnd((B, S, H, d), dt), rnd((B, S, KV, d), dt), rnd((B, S, KV, d), dt)
            ms = cs.cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True,
                                                               window=window), 3)
            out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
            dout = rnd((B, S, H, d), dt)
            bms = cs.cuda_ms(torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                                                    causal=True, window=window), 2)
            print(f"time {dt} d{d} H{H} KV{KV} w{window}: fwd {ms:.3f} ms bwd {bms:.3f} ms",
                  flush=True)
            del q, k, v, out, lse, dout
            torch.cuda.empty_cache()
    if "serve" in what:
        for arch in ("whisper_small", "recurrentgemma_9b", "paligemma_3b", "qwen3_32b"):
            t1 = time.time()
            p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                                "--reduced"], capture_output=True, text=True, cwd=ROOT,
                               env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                               timeout=300)
            print(f"serve {arch} --reduced: rc {p.returncode} in {time.time() - t1:.1f} s; "
                  + p.stdout[-400:].replace("\n", " | ") + p.stderr[-1500:], flush=True)
            if p.returncode:
                fails.append(f"serve {arch}")
    print("FAILS", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
