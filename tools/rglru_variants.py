#!/usr/bin/env python3
"""Time edited copies of the forward RG-LRU scan against the unedited one.

    python3 tools/rglru_variants.py [NAME ...] [FILE.cu ...]

Each NAME is ``csrc/rglru_scan.cu`` with a few text edits (``VARIANTS``):
the tile's warps a block (NW) and steps a piece (L). A FILE.cu argument is
a whole other source with the same C entry points, such as an earlier
commit's copy (``git show REV:src/repro_torch/csrc/rglru_scan.cu >
build/dev/rglru_scan_REV.cu``). All copies are compiled side by side (one
``nvcc`` each, in parallel) into the git-ignored ``build/variants/``, loaded
with ``ctypes`` and called through ``kernels.rglru_scan``'s own wrapper.
Each prints its registers and spills (``ptxas -v``) and its largest
difference from the unedited copy, then, at recurrentgemma-9b's training
shape (B=2, S=4096, W=4096), its prefill shape (B=4, S=2048, W=4096) and
calibration's (1, 256, 512), its time in turns with the unedited copy
(``chip_smoke.paired_ms``: variant, base, base, variant; medians of CUDA
event times), so that a difference is read within one call on one card.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

NW = "constexpr int NW = 8;"
L = "constexpr int L = 16;"
BOUNDS = "__launch_bounds__(NW * 32, 2)"
VARIANTS = {
    "nw4": [(NW, "constexpr int NW = 4;")],                  # rounds of 64 steps, 128 threads
    "nw16": [(NW, "constexpr int NW = 16;"),                 # rounds of 256 steps, 512 threads
             (BOUNDS, "__launch_bounds__(NW * 32, 1)")],
    "l8": [(L, "constexpr int L = 8;")],                      # half the loads in flight a thread
    "l32": [(L, "constexpr int L = 32;"),                     # twice; one block a SM by registers
            (BOUNDS, "__launch_bounds__(NW * 32, 1)")],
}
# (name, (B, S, W)): the shapes chip_smoke.py times and calibration's
SHAPES = [("recurrentgemma_9b train", (2, 4096, 4096)),
          ("recurrentgemma_9b prefill", (4, 2048, 4096)),
          ("calibration", (1, 256, 512))]


def build(names):
    """{name: (typed library, ptxas lines of its kernels)} for the unedited
    source and each variant."""
    from repro_torch.kernels import _build, rglru_scan
    src = (_build.CSRC / "rglru_scan.cu").read_text()
    out_dir = os.path.join(REPO, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ["base", *names]:
        if name.endswith(".cu"):
            with open(name) as f:
                text = f.read()
        else:
            text = src
            for old, new in ([] if name == "base" else VARIANTS[name]):
                if old not in text:
                    raise ValueError(f"variant {name}: {old!r} not in the source")
                text = text.replace(old, new)
        path = os.path.join(out_dir, "rglru_" + os.path.basename(name).removesuffix(".cu") + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        facts, fn = [], "?"
        for ln in log.splitlines():      # ptxas -v: each entry function, then its facts
            if m := re.search(r"entry function '\w*?(rglru_\w*?kernel)", ln):
                fn = m.group(1)
            elif re.search(r"registers|spill stores", ln):
                facts.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
        libs[name] = rglru_scan._bind(ctypes.CDLL(path[:-3] + ".so")), facts
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import rglru_scan
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(names)
    for name, (_, facts) in libs.items():
        print(f"[{card}] {name} ptxas: " + "; ".join(facts), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def caller(name, a, b):
        def run():
            rglru_scan._lib = lambda: libs[name][0]
            return rglru_scan.rglru_scan(a, b)
        return run
    for shape_name, (B, S, W) in SHAPES:
        a = -torch.randn((B, S, W), generator=gen, device="cuda").abs() * 0.5
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        h0, hl0 = caller("base", a, b)()
        for name in names:
            h, hl = caller(name, a, b)()
            diff = max(float((h - h0).abs().max()), float((hl - hl0).abs().max()))
            ms, base_ms, _ = chip_smoke.paired_ms(torch, caller(name, a, b), caller("base", a, b),
                                                  reps=20, rounds=5, warmup=3)
            print(f"[{card}] {shape_name} (B={B}, S={S}, W={W}): {name} {ms:.4f} ms, unedited "
                  f"{base_ms:.4f} ms (medians of turns); max abs difference {diff:.3e}",
                  flush=True)
        del a, b, h0, hl0
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
