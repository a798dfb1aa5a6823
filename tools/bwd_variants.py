#!/usr/bin/env python3
"""Time edited copies of the bf16 flash backward against the unedited one.

    python3 tools/bwd_variants.py [NAME ...]

Each variant is ``csrc/flash_attention_bwd.cu`` with a few text edits
(``VARIANTS``). All copies are compiled side by side (one ``nvcc`` each,
in parallel) into the git-ignored ``build/variants/``, loaded with
``ctypes`` and called as ``kernels.flash_attention.flash_attention_bwd``
calls the built library. At qwen3-32b's and h2o-danube-1.8b's training
shapes and granite-20b's 48-head group, each variant is timed in turns
with the unedited copy (``chip_smoke.paired_ms``: variant, base, base,
variant; medians), so that a difference is read within one call on one
card. Edits that drop work (``no_reduce``, ``no_dq``) give wrong results
and only split a step's time. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

WALK = "const bool down = window < 0 || window >= S;"
REDUCE = "    if (ctid == 0)\n      bulk_reduce_add("
DQ = "    if (NSLAB == 2 || (i & 1) == cw) {"
GRID = """  const int kvh = x % KV;
  x /= KV;
  const int b = x % B;
  x /= B;
  const int sp = x % n_split;
  const int k0 = (x / n_split) * BKEYS;"""
GRID_KT = """  const int n_kt = (S + BKEYS - 1) / BKEYS;
  const int k0 = x % n_kt * BKEYS;
  x /= n_kt;
  const int kvh = x % KV;
  x /= KV;
  const int b = x % B;
  const int sp = x / B;"""
VARIANTS = {
    "walk_up": [(WALK, "const bool down = false;")],        # each head's tiles upward
    "walk_down": [(WALK, "const bool down = true;")],       # tiles from S down, heads inner
    "grid_kt_fastest": [(GRID, GRID_KT)],                   # a group's key tiles side by side
    "no_reduce": [(REDUCE, "    if (false)\n      bulk_reduce_add(")],
    "no_dq": [(DQ, "    if (false) {")],
}
# (name, (B, S, H, KV, d), window): the timed shapes of chip_smoke.py
SHAPES = [("qwen3_32b train", (2, 4096, 64, 8, 128), None),
          ("h2o_danube_1_8b train", (2, 8192, 32, 8, 80), 4096),
          ("granite_20b G=48", (1, 4096, 48, 1, 128), None)]


def build(names):
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ["base", *names]:
        text = src
        for old, new in VARIANTS.get(name, []):
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so",
                                        path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def caller(torch, lib, q, k, v, out, lse, dout, window):
    """One call of ``lib``'s backward, as the wrapper makes it (bf16)."""
    from repro_torch.kernels.flash_attention import bwd_split_plan
    B, S, H, d = q.shape
    KV = k.shape[2]
    n_split = bwd_split_plan(B, S, KV, H // KV)
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(B, S, H, KV, d, 1, n_split),
                          dtype=torch.float32, device=q.device)
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def run():
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), *(g.data_ptr() for g in grads), B, S, H, KV, d, 1,
            -1 if window is None else window, n_split, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd variant: error {err}")
    return run


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ops
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape_name, (B, S, H, KV, d), window in SHAPES:
        q, k, v = (torch.randn((B, S, n, d), generator=gen, device="cuda").bfloat16()
                   for n in (H, KV, KV))
        dout = torch.randn((B, S, H, d), generator=gen, device="cuda").bfloat16()
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
        base = caller(torch, libs["base"], q, k, v, out, lse, dout, window)
        for name in names:
            ms, base_ms, _ = chip_smoke.paired_ms(
                torch, caller(torch, libs[name], q, k, v, out, lse, dout, window), base, reps=5,
                rounds=3, warmup=2)
            print(f"[{card}] {shape_name}: {name} {ms:.3f} ms, unedited {base_ms:.3f} ms "
                  f"(medians of turns)", flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
