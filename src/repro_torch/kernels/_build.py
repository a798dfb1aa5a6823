"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain C entry points (pointers, ints, a
stream) and is compiled on its own by ``nvcc`` for Hopper (``sm_90a``)
into ``build/repro_torch/<name>-<hash>.so`` at the repository root. The
hash covers the source and the flags, so an edited source builds anew and
an unchanged one is reused. Nothing is compiled at import time: the CPU
tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process or None, target, tmp)."""
    target = _target(name)
    if target.exists():
        return None, target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, target, tmp


def _finish(name: str, proc, target: Path, tmp) -> str:
    log_file = target.with_suffix(".log")
    if proc is None:
        return log_file.read_text() if log_file.exists() else ""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_file.write_text(log)
    os.replace(tmp, target)          # atomic: concurrent builders never see half a file
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources in parallel (one ``nvcc`` each, all started
    together). Returns each compiler log (``-Xptxas -v``: registers, shared
    memory, spills), also for a library built earlier."""
    names = list(names)
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if it is not yet.
    Each wrapper loads its library once and keeps it."""
    build([name])
    return ctypes.CDLL(str(_target(name)))

