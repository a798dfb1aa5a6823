"""The no-grad guard of the kernels that have no backward on the card yet.

Their CUDA wrappers return fresh tensors that autograd cannot see through,
so a call that needs a gradient would silently drop every path through the
kernel. Such a call raises instead, naming the ROADMAP item that brings the
backward. CPU tensors take the plain versions, which autograd differentiates.
"""
from __future__ import annotations

import torch


def require_no_grad(kernel: str, item: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no backward on the card yet (ROADMAP: {item}); call it under "
            "torch.no_grad() or with inputs that do not require grad")
