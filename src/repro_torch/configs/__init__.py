"""Assigned architectures (exact public configs) + input-shape sets.

Every entry is selectable via ``--arch <id>`` in the launchers. The
``shapes`` table defines the 4 assigned input shapes; per-arch skips
(long_500k for pure full-attention archs) are encoded in
``applicable_shapes`` and documented in DESIGN.md §Arch-applicability.

A copy of ``repro.configs`` (whose import loads JAX through
``repro.models``); ``tests/test_torch_configs.py`` holds the two equal.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from ..models.config import ArchConfig

ARCH_IDS = [
    "qwen3_32b", "granite_20b", "h2o_danube_1_8b", "granite_8b",
    "mamba2_780m", "recurrentgemma_9b", "olmoe_1b_7b", "deepseek_v2_236b",
    "whisper_small", "paligemma_3b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic / bounded-window attention run long_500k
SUBQUADRATIC = {"mamba2_780m", "recurrentgemma_9b", "h2o_danube_1_8b"}


def get_config(arch: str) -> ArchConfig:
    arch = _ALIAS.get(arch, arch)
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def reduced_config(arch: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    arch = _ALIAS.get(arch, arch)
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.REDUCED


def applicable_shapes(arch: str) -> List[ShapeSpec]:
    arch = _ALIAS.get(arch, arch)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in SUBQUADRATIC:
        out.append(SHAPES["long_500k"])
    return out


def all_cells() -> List[Tuple[str, ShapeSpec]]:
    """Every assigned (arch × shape) cell (40 incl. documented skips)."""
    cells = []
    for a in ARCH_IDS:
        for s in applicable_shapes(a):
            cells.append((a, s))
    return cells
