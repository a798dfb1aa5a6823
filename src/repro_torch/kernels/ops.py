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
* ``"replicate"``: anything else: q, k and v are gathered to
  ``Replicate()`` first, as XLA does around an opaque custom call, and the
  output is returned in q's placements.

``decode_attention`` on DTensors (``decode_branch`` counts its branches)
takes ``"sharded_keys"`` when the cache is
laid out as ``ShardingRules.cache_specs`` lays it out (each mesh dim
replicating it, or sharding its batch or its sequence, evenly): each rank
gathers q over heads (it is (B, 1, H, d)), runs the decode kernel's
sharded-keys mode on its own shard of the cache, with the shard's offset
in the sequence, and the ranks that share a batch row merge their partials
by log-sum-exp (``merge_partials``, one all-reduce of the maxima and one of
the weighted sums over the mesh dims that shard the sequence; none on a
mesh dim of one rank). MLA's latent decode (``models.attention``, counted
as ``"sharded_keys"`` too) and whisper's cross-attention at decode go
through the same merge. Other cache layouts take ``"replicate"`` (counted
in both dicts).

``ssd_scan`` and ``rglru_scan`` run on DTensors shard by shard with the
sequence whole (``scan_on_shards``): each rank scans its batch rows (and
its RG-LRU channels).

A pending sum (``Partial()``, a projection whose contraction DTensor
sharded) is carried out first. ``dtensor_branch`` counts the branches taken.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ..models.sharding_utils import (is_dtensor, key_shard, on_shards, relayout, replicate_like,
                                    rows_of)
from ..models.sharding_utils import summed as _summed
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import rglru_scan as _rglru
from . import ssd_scan as _ssd
from .decode_attention import NEG_INF
from .flash_attention import flash_attention_bwd, flash_attention_fwd
from .rglru_scan import rglru_scan_bwd
from .ssd_scan import ssd_scan_bwd

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd", "attend_on_shards",
           "dtensor_branch", "decode_branch", "merge_partials"]

dtensor_branch = {"local": 0, "replicate": 0}
decode_branch = {"sharded_keys": 0, "replicate": 0}


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


def merge_partials(o: torch.Tensor, lse: torch.Tensor, mesh, dims: Sequence[int]
                   ) -> torch.Tensor:
    """Local tensors: each rank's attention output ``o`` (..., d) float32,
    normalised over its own keys, and ``lse`` (...) float32, the log of its
    softmax denominator (NEG_INF where it holds no live key) -> the output
    over the keys of every rank of the mesh dims ``dims``, float32: M = the
    ranks' largest lse, w = exp(lse - M) (0 for NEG_INF), o = sum(w o) /
    sum(w) (0 where no rank has a live key). One all-reduce of M and one of
    the weighted sums and weights a mesh dim; none for no dims, where the
    merge of one partial returns ``o`` bit for bit."""
    import torch.distributed as dist
    groups = [mesh.get_group(i) for i in dims]
    m = lse.clone()
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    w = torch.where(lse > NEG_INF, torch.exp(lse - m), 0.0)[..., None]
    acc = torch.cat([o * w, w], dim=-1)
    for g in groups:
        dist.all_reduce(acc, group=g)
    num, den = acc[..., :-1], acc[..., -1:]
    return torch.where(den > 0, num / den.clamp(min=1e-30), 0.0)


def _sharded_keys(q, k_cache, v_cache, cache_len, at: Tuple[int, Tuple[int, ...]],
                  window: Optional[int], scale: Optional[float]):
    """The ``"sharded_keys"`` branch (module docstring): q gathered over
    heads and laid out by the cache's batch rows, the decode kernel's
    sharded-keys mode on this rank's shard, the partials merged over the
    mesh dims that shard the sequence; the output in q's placements."""
    from torch.distributed.tensor import DTensor
    decode_branch["sharded_keys"] += 1
    mesh = q.device_mesh
    rows = rows_of(k_cache)
    offset, dims = at
    q = _summed(q)
    q_loc = relayout(q, rows).to_local()
    lens = relayout(_summed(replicate_like(cache_len, q)), rows).to_local()
    o, lse = _decode.decode_attention_partial(q_loc, k_cache.to_local(), v_cache.to_local(),
                                              lens, kv_offset=offset, window=window, scale=scale)
    o = merge_partials(o, lse[:, None], mesh, dims).to(q.dtype)
    out = DTensor.from_local(o, mesh, rows, run_check=False, shape=q.shape, stride=q.stride())
    return relayout(out, q.placements)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``decode_attention.decode_attention`` (see there); DTensors take the
    ``"sharded_keys"`` branch for caches laid out by ``cache_specs``, else
    the ``"replicate"`` branch (module docstring)."""
    fn = functools.partial(_decode.decode_attention, window=window, scale=scale)
    if not is_dtensor(q, k_cache, v_cache, cache_len):
        return fn(q, k_cache, v_cache, cache_len)
    _check_mesh("decode_attention", q, k_cache, v_cache)
    at = key_shard(k_cache)
    if at is not None and tuple(k_cache.placements) == tuple(v_cache.placements):
        return _sharded_keys(q, k_cache, v_cache, cache_len, at, window, scale)
    decode_branch["replicate"] += 1
    return _replicated(fn, q, k_cache, v_cache, cache_len)


def scan_on_shards(fn, args: Sequence, keep: Sequence[int], outs_dims: Sequence[Sequence[int]]):
    """``fn`` of local tensors on DTensor ``args`` (B, S, ...), each rank on
    its own shard with the sequence whole: every mesh dim that shards the
    first argument on a dim in ``keep`` keeps it, every other mesh dim
    replicates; output i is laid out likewise on its dims ``outs_dims[i]``
    (in ``keep``'s order)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if any(p.is_shard(d) for d in keep) else Replicate()
               for p in args[0].placements)

    def out_pl(dims):
        return tuple(Shard(dims[keep.index(p.dim)]) if p.is_shard() else p for p in pl)
    return on_shards(fn, args, ins=(pl,) * len(args), outs=tuple(out_pl(d) for d in outs_dims))


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan.ssd_scan`` (see there); DTensors scan each rank's batch
    rows (``scan_on_shards``)."""
    fn = functools.partial(_ssd.ssd_scan, chunk=chunk)
    if not is_dtensor(x, a_log, b, c):
        return fn(x, a_log, b, c)
    return scan_on_shards(fn, (x, a_log, b, c), (0,), ((0,), (0,)))


def rglru_scan(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan.rglru_scan`` (see there); DTensors scan each rank's batch
    rows and channels (``scan_on_shards``)."""
    if not is_dtensor(a_log, b):
        return _rglru.rglru_scan(a_log, b)
    return scan_on_shards(_rglru.rglru_scan, (a_log, b), (0, 2), ((0, 2), (0, 1)))
