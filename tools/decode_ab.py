"""Time the decode kernel of this checkout against another source of
``csrc/decode_attention.cu`` on one card, in turns (other, this, this,
other; 7 rounds of 20 launches each, L2 flushed before each launch), at
the serving paths' bf16 decode shapes, through the existing entry
``decode_attention_fwd`` with the same inputs, and say whether the two
outputs are bitwise equal.

    git show <commit>:src/repro_torch/csrc/decode_attention.cu > build/other_decode.cu
    python3 tools/decode_ab.py build/other_decode.cu

Both sources are built with the checkout's ``nvcc`` flags into
``build/decode_ab/``. Prints one line a shape with the card's name and
power limit: each side's median ms and its range, their ratio.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHAPES = [("d128", (4, 4128, 64, 8, 128)), ("d80", (4, 4128, 32, 8, 80)),
          ("d256", (4, 2048, 16, 1, 256)), ("G48", (4, 4128, 48, 1, 128)),
          ("G1", (4, 4128, 16, 16, 128)), ("whisper", (4, 256, 12, 12, 64)),
          ("paligemma", (4, 416, 8, 1, 256))]


def _lib(src: str, name: str):
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "decode_ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, name + ".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    lib.decode_attention_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    return lib


def main(other: str) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import split_plan
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {"other": _lib(other, "other"),
            "this": _lib(os.path.join(ROOT, "src/repro_torch/csrc/decode_attention.cu"), "this")}
    flush = cs.l2_flush(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (B, T, H, KV, d) in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((B, 1, H, d), (B, T, KV, d), (B, T, KV, d)))
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        split_len, n_splits = split_plan(T, B, KV, H // KV)
        ml = torch.empty((B, H, n_splits, 2), device="cuda")
        acc = torch.empty((B, H, n_splits, d), device="cuda")
        outs = {side: torch.empty_like(q) for side in libs}

        def launch(side):
            def run():
                err = libs[side].decode_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), ml.data_ptr(),
                    acc.data_ptr(), outs[side].data_ptr(), B, T, H, KV, d, 1, -1, split_len,
                    n_splits, d ** -0.5, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"decode_attention_fwd ({side}) returned {err}")
            return run
        for side in libs:
            launch(side)()
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        ms = {side: [] for side in libs}
        for _ in range(7):
            for side in ("other", "this", "this", "other"):
                ms[side].append(cs._events_ms(torch, launch(side), 20, flush))
        mo, mt = statistics.median(ms["other"]), statistics.median(ms["this"])
        print(f"[{card}] decode {name} B={B} T={T} H={H} KV={KV} d={d}: other {mo:.4f} ms "
              f"({min(ms['other']):.4f}-{max(ms['other']):.4f}), this {mt:.4f} ms "
              f"({min(ms['this']):.4f}-{max(ms['this']):.4f}), ratio {mt / mo:.3f}; outputs "
              f"bitwise equal: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
