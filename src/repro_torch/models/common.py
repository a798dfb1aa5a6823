"""Shared building blocks: norms, rotary embeddings, initializers.

PyTorch counterpart of ``repro.models.common``. Initializers draw from an
explicit ``torch.Generator`` and create tensors on that generator's device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .sharding_utils import replicate_like


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; asking for a missing card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
               ) -> torch.Tensor:
    """Rotary embedding, split-half layout. x: (..., seq, heads, head_dim);
    positions: (..., seq), a DTensor under a mesh at decode (laid out as
    the batch)."""
    hd = x.shape[-1]
    freqs = replicate_like(rope_freqs(hd, theta, device=x.device), positions)   # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = replicate_like(torch.cos(angles)[..., None, :], x)    # (..., seq, 1, hd/2)
    sin = replicate_like(torch.sin(angles)[..., None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# -- initializers ----------------------------------------------------------------
# ``lead`` prepends stacking dimensions (the per-unit layer axis) without
# changing the fan-in, which is always read from the per-layer ``shape``.
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: Optional[int] = None, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[0]
    w = torch.randn(lead + tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(fan ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(0.02).to(dtype)


def zeros(shape: Tuple[int, ...], device, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)

