"""Two guards of the CUDA wrappers.

``refuse_dtensor``: a DTensor's ``is_cuda`` is its local tensor's, so a
card's DTensor would reach a C entry point, which reads raw pointers of
whole tensors. The wrappers refuse one; ``ops.flash_attention`` and
``ops.decode_attention`` take DTensors and hand the kernels local tensors.

``require_no_grad``: the no-grad guard of the one kernel that has no backward on the card:
``decode_attention``, which only serving calls (the JAX package takes no
gradient through its decode either).

Its CUDA wrapper returns fresh tensors that autograd cannot see through,
so a call that needs a gradient would silently drop every path through the
kernel. Such a call raises instead, naming the ROADMAP item it would need.
CPU tensors take the plain version, which autograd differentiates.
"""
from __future__ import annotations

import torch


def require_no_grad(kernel: str, item: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no backward on the card yet (ROADMAP: {item}); call it under "
            "torch.no_grad() or with inputs that do not require grad")


def refuse_dtensor(kernel: str, *tensors: torch.Tensor) -> None:
    from ..models.sharding_utils import is_dtensor
    if is_dtensor(*tensors):
        raise TypeError(f"{kernel}: a DTensor reached the kernel's wrapper; call "
                        "repro_torch.kernels.ops, which runs the kernel on local tensors")
