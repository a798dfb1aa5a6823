"""The port's serve driver (repro_torch.launch.serve) on the CPU, its
refusal to fall back when the card is missing, and the port's isolation
from JAX and from the JAX package."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import serve

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARGS = ["--arch", "qwen3_32b", "--reduced", "--batch", "2", "--prompt-len", "12",
        "--gen-len", "5"]


@pytest.mark.parametrize("arch", ["qwen3_32b", "mamba2_780m", "recurrentgemma_9b",
                                  "h2o_danube_1_8b", "olmoe_1b_7b", "deepseek_v2_236b",
                                  "whisper_small", "paligemma_3b"])
def test_serve_reduced_on_cpu_prints_latency(capsys, arch):
    out = serve.main(["--arch", arch] + ARGS[2:] + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "prefill(12 tokens)" in text and "p50=" in text and "p99=" in text
    assert out["p50_ms"] > 0 and out["p99_ms"] >= out["p50_ms"]
    assert out["last_token"].shape == (2, 1)
    assert np.all((out["last_token"] >= 0) & (out["last_token"] < 512))


def test_serve_asking_for_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(ARGS + ["--device", "cuda"])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
        "print(' '.join(m for m in sys.modules if m.startswith('repro_torch')))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    count, names = res.stdout.splitlines()[-2:]
    assert int(count.split()[0]) >= 90
    # the planning stack's subpackages, the scenario CLI among them
    for mod in ("scenarios.__main__", "strategies.splits", "control.plane", "sim.fleet",
                "fleet.session", "resilience.engine", "core.events", "runtime.heartbeat"):
        assert f"repro_torch.{mod}" in names.split(), mod
