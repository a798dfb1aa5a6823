"""Serving step builders (PyTorch counterpart of
``repro.launch.steps.make_prefill_step`` / ``make_serve_step``): greedy
argmax to int32 tokens of shape (B, 1)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models import Model, build_model
from ..models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def prefill_step(params, tokens, cache):
        logits, cache = model.prefill(params, tokens, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return model, prefill_step


def make_serve_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def serve_step(params, token, cache, pos):
        logits, cache = model.decode(params, token, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return model, serve_step
