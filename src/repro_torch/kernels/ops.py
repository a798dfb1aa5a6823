"""Public kernel entry points.

Dispatch goes by the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, a CPU tensor takes the plain
PyTorch version (``ref.py``). There is no switch that sends a CUDA tensor
down the plain path, and no shape condition: the JAX package's tile
conditions (``src/repro/kernels/ops.py``) come from its Pallas tiling,
which the CUDA kernels do not share.

DTensors (a model under a device mesh) enter ``flash_attention`` and
``decode_attention`` here, on the CPU and the card alike, through one entry
(``attend_on_shards``, which ``models.attention`` also takes for its plain
attention), and the kernels see local tensors only, dispatched by their
device as above:

* ``"local"``: q, k and v laid out alike, each mesh dim of more than one
  rank replicating them or sharding their batch or head dim, with the same
  group ratio H/KV on every rank: each rank runs the kernel on its own
  heads and batch rows (``local_map``, so ``FlashAttentionFn``'s backward
  stays in play);
* ``"replicate"``: anything else, and decode: q, k and v are gathered to
  ``Replicate()`` first, as XLA does around an opaque custom call, and the
  output is returned in q's placements.

A pending sum (``Partial()``, a projection whose contraction DTensor
sharded) is carried out first. ``dtensor_branch`` counts the branches taken.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..models.sharding_utils import is_dtensor
from . import decode_attention as _decode
from . import flash_attention as _flash
from .flash_attention import flash_attention_bwd, flash_attention_fwd
from .rglru_scan import rglru_scan, rglru_scan_bwd
from .ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd", "attend_on_shards",
           "dtensor_branch"]

dtensor_branch = {"local": 0, "replicate": 0}


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a DTensor
    takes a local gradient as it comes, and its view propagation later
    views it as if it were contiguous (the plain attention's einsum
    backward returns permuted gradients; the card's kernels contiguous
    ones, which this leaves alone)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_local(fn):
    """``fn`` with contiguous gradients for its tensor arguments."""
    def run(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return run


def _heads_local(q, k, v) -> bool:
    """Whether each rank can attend its own slice of q, k and v alone: every
    mesh dim of more than one rank lays them out alike, replicated or
    sharded on batch (dim 0) or heads (dim 2), and the shards divide B, H
    and KV evenly (so every rank keeps the group ratio H/KV)."""
    sizes = tuple(q.device_mesh.shape)
    f_batch = f_heads = 1
    for n, a, b, c in zip(sizes, q.placements, k.placements, v.placements):
        if n == 1:
            continue
        if not a == b == c:
            return False
        if a.is_shard(0):
            f_batch *= n
        elif a.is_shard(2):
            f_heads *= n
        elif not a.is_replicate():
            return False
    return q.shape[0] % f_batch == 0 and q.shape[2] % f_heads == 0 \
        and k.shape[2] % f_heads == 0


def _replicated(fn, q, *rest):
    """``fn`` on the full tensors (DTensor arguments gathered to
    ``Replicate()``), its output in q's placements."""
    from torch.distributed.tensor import DTensor, Replicate
    dtensor_branch["replicate"] += 1
    mesh = q.device_mesh
    rep = [Replicate()] * mesh.ndim
    args = [t.redistribute(mesh, rep).to_local() if isinstance(t, DTensor) else t
            for t in (q,) + rest]
    out = DTensor.from_local(_on_local(fn)(*args), mesh, rep, run_check=False)
    return out.redistribute(mesh, q.placements)


def _check_mesh(name: str, *tensors) -> None:
    from torch.distributed.tensor import DTensor
    if not all(isinstance(t, DTensor) and t.device_mesh == tensors[0].device_mesh
               for t in tensors):
        raise TypeError(f"{name}: q and the keys and values must be DTensors of one mesh, "
                        "or none of them")


def _summed(t):
    """The DTensor ``t`` with its pending sums (a projection whose
    contraction DTensor sharded) carried out: ``Partial()`` placements
    become ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def attend_on_shards(fn, q, k, v):
    """The DTensor entry: attention ``fn(q, k, v)`` of local tensors applied
    to DTensors q, k, v through the ``"local"`` or the ``"replicate"``
    branch (module docstring)."""
    _check_mesh("attention", q, k, v)
    q, k, v = (_summed(t) for t in (q, k, v))
    if not _heads_local(q, k, v):
        return _replicated(fn, q, k, v)
    from torch.distributed.tensor.experimental import local_map
    dtensor_branch["local"] += 1
    return local_map(_on_local(fn), out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=q.device_mesh)(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention.flash_attention`` (see there); DTensors go through
    ``attend_on_shards``."""
    fn = functools.partial(_flash.flash_attention, causal=causal, window=window, scale=scale)
    return attend_on_shards(fn, q, k, v) if is_dtensor(q, k, v) else fn(q, k, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``decode_attention.decode_attention`` (see there); DTensors take the
    ``"replicate"`` branch (serving under a mesh is not ported yet)."""
    fn = functools.partial(_decode.decode_attention, window=window, scale=scale)
    if not is_dtensor(q, k_cache, v_cache, cache_len):
        return fn(q, k_cache, v_cache, cache_len)
    _check_mesh("decode_attention", q, k_cache, v_cache)
    return _replicated(fn, q, k_cache, v_cache, cache_len)
