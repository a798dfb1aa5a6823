"""Gradient compression for cross-pod synchronisation (PyTorch counterpart
of ``repro.optim.compress``).

int8 quantisation with error feedback (EF-SGD style): the quantisation
residual is carried into the next step, so compression adds no bias to the
long-run gradient signal. Intended for the slow pod axis: the intra-pod
all-reduces stay full precision; the planner models the 4x byte saving via
``Workload.grad_compression``.

The arithmetic is the JAX package's: a per-tensor absmax scale
``max|x| / 127 + 1e-12`` in float32, ``round`` half to even (as
``jnp.round``), a clip to +-127, then int8; the residual ``corrected - deq``
in float32. Trees are the port's nested dicts (``optim.adamw.tree_map``).
``ef_residual_norm`` stays a 0-d tensor on the gradients' device, so a
step never waits on the host.

Under a device mesh the leaves are DTensors: a leaf's scale is the absmax
of the whole tensor, reduced across its shards and gathered once (as
``global_norm`` gathers its sum), and the elementwise work runs on each
rank's local slice, laid out as the leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models.sharding_utils import is_dtensor
from .adamw import global_norm, tree_map

_EPS = 1e-12


def _settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending (partial) sums reduced, so every rank's
    local slice holds final values; a plain tensor as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def _local(fn: Callable[..., torch.Tensor], *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over plain tensors, or over the local slices of DTensors laid
    out alike, its result wrapped as a DTensor laid out as ``xs[0]``."""
    if not is_dtensor(*xs):
        return fn(*xs)
    from torch.distributed.tensor import DTensor
    x0 = xs[0]
    out = fn(*(x.to_local() for x in xs))
    return DTensor.from_local(out, x0.device_mesh, x0.placements, run_check=False,
                              shape=x0.shape, stride=x0.stride())


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantisation -> (q int8, scale f32 0-d)."""
    x = _settled(x)
    amax = torch.amax(torch.abs(x))
    if is_dtensor(amax):
        amax = amax.full_tensor()
    # a divisor on amax's device: a CUDA tensor divided by a Python number is
    # multiplied by its float32 reciprocal, ~1 ulp off the quotient for ~5% of
    # values, where JAX (and the CPU) divide
    scale = amax.float() / torch.full((), 127.0, device=amax.device) + _EPS
    q = _local(lambda t: torch.clamp(torch.round(t.float() / scale), -127, 127)
               .to(torch.int8), x)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _local(lambda t: t.float() * scale, q)


def ef_init(params) -> Any:
    """Error-feedback residual state: float32 zeros laid out like ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def ef_compress(grads, ef_state) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Compress ``grads`` with error feedback.

    Returns (the decompressed gradients, in each gradient's dtype: what a
    receiver reconstructs after the int8 all-reduce; the new residual state;
    ``{"ef_residual_norm"}``, the residual's global L2 norm)."""
    def one(g, e):
        corrected = _local(lambda a, b: a.float() + b, _settled(g), e)
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return _local(lambda t: t.to(g.dtype), deq), _local(torch.sub, corrected, deq)

    out = tree_map(one, grads, ef_state)          # (deq, residual) pairs as leaves
    new_g = tree_map(lambda o: o[0], out)
    new_e = tree_map(lambda o: o[1], out)
    return new_g, new_e, {"ef_residual_norm": global_norm(new_e)}
