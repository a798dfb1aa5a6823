"""Dense MLP block, gated or standard (PyTorch counterpart of
``repro.models.mlp.init_mlp`` / ``apply_mlp``). MoE is not ported yet."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import activation, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, dtype,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
         "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, lead=lead)
    return p


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    fn = activation(act)
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = fn(x @ p["w_gate"]) * h
    else:
        h = fn(h)
    return h @ p["w_down"]
