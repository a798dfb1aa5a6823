#!/usr/bin/env python3
"""Time edited copies of the bf16 SSD backward against the unedited one.

    python3 tools/ssd_bwd_variants.py [NAME ...]

Each variant is ``csrc/ssd_scan_bwd.cu`` with a few text edits
(``VARIANTS``). All copies are compiled side by side (one ``nvcc`` each, in
parallel) into the git-ignored ``build/variants/``, loaded with ``ctypes``
and run through ``kernels.ssd_scan``'s own stage wrappers. At mamba2-780m's
training shape (B=4, S=4096, 48 heads of 64, N 128, chunk 256) each variant
is timed in turns with the unedited copy (variant, base, base, variant;
medians of CUDA-event times), the whole backward and each of its six
stages, so that a difference is read within one call on one card. Edits
that drop work (``*_no_*``) give wrong results and only split a stage's
time. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

K1_DPREV = "          product(Ds, Cs, es + q * TILE + k0 + ln.t2, dacc);\n"
K1_MMA = """                for (int part = 0; part < 3; ++part) {
                  mma16816(acc[2 * np], a[part], b0, b1);"""
K5_HEADS = "  const int n_units = n_dcb + rep;"
K5_PLANES = "          for (int plane = 0; plane < 3; ++plane) {"
MMA = """  asm volatile(
      "mma.sync.aligned.m16n8k16"""
VARIANTS = {
    "mma_not_volatile": [(MMA, MMA.replace("asm volatile(", "asm("))],  # free to reorder
    "k1_no_dprev": [(K1_DPREV, "")],                                 # one product, not two
    "k1_two_parts": [(K1_MMA, K1_MMA.replace("part < 3", "part < 2"))],  # hi + mid only
    "k1_no_mma": [(K1_MMA, K1_MMA.replace("part < 3", "part < 0"))],   # loads only
    "k5_no_heads": [(K5_HEADS, "  const int n_units = n_dcb;")],     # the dcb products only
    "k5_one_plane": [(K5_PLANES, K5_PLANES.replace("plane < 3", "plane < 1"))],
}
SHAPE = (4, 4096, 48, 64, 1, 128, 256)          # B, S, H, P, G, N, chunk
STAGES = ("chunk_state", "state_passing", "dcb", "dx", "dbdc", "da")


def build(names):
    from repro_torch.kernels import _build, ssd_scan
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ["base", *names]:
        text = src
        for old, new in VARIANTS.get(name, []):
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"ssd_{name}.cu")
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
        libs[name] = ssd_scan._bind_bwd(ctypes.CDLL(os.path.join(out_dir, f"ssd_{name}.so")))
    return libs


def stage_times(torch, x, a, b, c, dy, chunk):
    """Each stage of one backward call (as ``ssd_scan_bwd`` chains them),
    timed by CUDA events, and the whole call's time."""
    from repro_torch.kernels import ssd_scan as s
    P, N = x.shape[3], b.shape[3]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
    ev[0].record()
    states, d_prev, a_cum = s.bwd_chunk_state_kernel(x, a, b, c, dy, chunk)
    ev[1].record()
    prev3, dst3, d_last = s.bwd_state_passing_kernel(states, d_prev, a_cum, None)
    ev[2].record()
    cbT, dcbT, d_intra = s.bwd_dcb_kernel(x, dy, b, c, a_cum)
    ev[3].record()
    s.bwd_dx_kernel(dy, b, a_cum, cbT, dst3)
    ev[4].record()
    _, _, d_state = s.bwd_dbdc_kernel(x, dy, b, c, a_cum, dcbT, prev3, dst3)
    ev[5].record()
    s.bwd_da_kernel(d_intra, d_state, d_last, P, N, chunk)
    ev[6].record()
    torch.cuda.synchronize()
    times = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(STAGES))]
    return dict(zip(STAGES, times), total=ev[0].elapsed_time(ev[-1]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ssd_scan
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(names)
    B, S, H, P, G, N, L = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((B, S, H, P), generator=gen, device="cuda") * 0.1).bfloat16()
    a = -torch.randn((B, S, H), generator=gen, device="cuda").abs() * 0.1
    b, c = ((torch.randn((B, S, G, N), generator=gen, device="cuda") * 0.1).bfloat16()
            for _ in range(2))
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda").bfloat16()

    def timed(name):
        ssd_scan._bwd_lib = lambda: libs[name]
        return stage_times(torch, x, a, b, c, dy, L)
    for name in names:
        for _ in range(2):                      # warm up both
            timed(name), timed("base")
        runs = {name: [], "base": []}
        for _ in range(5):                      # variant, base, base, variant
            for who in (name, "base", "base", name):
                runs[who].append(timed(who))
        med = {who: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
               for who, rs in runs.items()}
        print(f"[{card}] {name}: " + ", ".join(
            f"{k} {med[name][k]:.4f} ({med['base'][k]:.4f})" for k in (*STAGES, "total"))
            + " ms, unedited in brackets (medians of turns)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
