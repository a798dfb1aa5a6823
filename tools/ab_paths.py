"""Time chip_smoke.py's serving paths (phase 3) and training paths (phase 5)
for several checkouts of the repo on one card, each checkout in a process
of its own, in the order given: to compare two commits, unpack the other
one beside this checkout and name both, for example parent, change, change,
parent.

    git archive <commit> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/ab_paths.py build/parent . . build/parent [--out build/ab_paths.json]

Each run builds its checkout's kernels (once: later runs of the same
checkout reuse them), then runs every ``PATHS`` serving path and every
``TRAIN_PATHS`` training path of that checkout's chip_smoke.py, with their
own gates, and skips phase 5's checkpoint round trips. It prints one line
a path and run (prefill ms, decode p50 ms and tokens/s; the median train
step in ms), the card's name and power limit, and writes every number to
``--out`` (``build/ab_paths.json`` by default).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import dataclasses, gc, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
              "ssd_scan_bwd", "rglru_scan"])
card = sys.argv[2]
out = {"serve": {}, "train": {}}
for p in cs.PATHS:
    r = cs.phase_serve(torch, card, p)
    out["serve"][p.arch] = {k: r[k] for k in ("prefill_ms", "decode_p50_ms", "decode_p99_ms",
                                              "decode_tokens_s", "decode_ms")}
    gc.collect(); torch.cuda.empty_cache()
for p in cs.TRAIN_PATHS:
    r = cs.phase_train(torch, card, dataclasses.replace(p, checkpoint=False))
    out["train"][p.arch] = {k: r[k] for k in ("step_ms", "step_ms_median")}
    gc.collect(); torch.cuda.empty_cache()
print("AB_RESULT " + json.dumps(out), flush=True)
"""


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, in run order")
    ap.add_argument("--out", default=os.path.join("build", "ab_paths.json"))
    args = ap.parse_args(argv)
    roots = args.roots
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, "-c", RUN, root, card], capture_output=True,
                              text=True)
        res = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if proc.returncode != 0 or not res:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"run {i} ({root}) failed with exit code {proc.returncode}")
        r = json.loads(res[-1][len("AB_RESULT "):])
        runs.append(dict(run=i, root=root, **r))
        for arch, s in r["serve"].items():
            print(f"[{card}] run {i} {root}: serve {arch}: prefill {s['prefill_ms']:.3f} ms, "
                  f"decode p50 {s['decode_p50_ms']:.3f} ms, {s['decode_tokens_s']:.1f} tokens/s",
                  flush=True)
        for arch, t in r["train"].items():
            print(f"[{card}] run {i} {root}: train {arch}: median step "
                  f"{t['step_ms_median']:.3f} ms ({[round(x, 3) for x in t['step_ms']]})",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
