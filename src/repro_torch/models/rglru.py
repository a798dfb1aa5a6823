"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427), PyTorch
counterpart of ``repro.models.rglru``.

Temporal mixing = Conv1D(width 4) → RG-LRU, gated by a GeLU branch:

    r_t = σ(W_a x_t + b_a)            (recurrence gate)
    i_t = σ(W_x x_t + b_x)            (input gate)
    a_t = exp(−c · softplus(Λ) · r_t)
    h_t = a_t h_{t−1} + sqrt(1 − a_t²) · (i_t ⊙ x_t)

Prefill and training, from zero state, call ``ops.rglru_scan``: on a CUDA
tensor the kernel at any length and width, and when grad is needed its
autograd Function (``kernels.rglru_scan.RglruScanFn``, whose backward is
the ``rglru_scan_bwd`` kernel); on the CPU its plain version, through which
autograd differentiates. Decode, which carries {lru, conv} state, takes
``_rglru_scan`` (the plain scan), as the JAX package's decode takes its
oracle and not the Pallas kernel.
The functions are pure: the transformer writes the returned state into
the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.rglru_scan import rglru_scan_ref
from .common import dense_init
from .config import ArchConfig
from .sharding_utils import BATCH, P, maybe_shard, replicate_like

_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, w = cfg.d_model, cfg.lru_dim
    dev = gen.device
    # Λ so that a ≈ 0.9..0.999 at r = 1 (per the paper)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(0.9, 0.999, w, device=dev)) / _C))
    return {
        "w_in": dense_init(gen, (d, w), dtype, lead=lead),            # recurrent branch
        "w_gate_branch": dense_init(gen, (d, w), dtype, lead=lead),   # GeLU branch
        "conv_w": dense_init(gen, (cfg.conv_width, w), dtype, fan_in=cfg.conv_width,
                             lead=lead),
        "wa": dense_init(gen, (w, w), dtype, lead=lead),
        "wx": dense_init(gen, (w, w), dtype, lead=lead),
        "ba": torch.zeros(lead + (w,), device=dev),
        "bx": torch.zeros(lead + (w,), device=dev),
        "lam": lam.expand(lead + (w,)).clone(),
        "w_out": dense_init(gen, (w, d), dtype, fan_in=w, lead=lead),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv as the sum of shifted products (no cuDNN)."""
    K = w.shape[0]
    pad = replicate_like(torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                                     device=x.device), x) if tail is None else tail
    xp = torch.cat([pad, x], dim=1)
    return sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))


def _rglru_scan(b: torch.Tensor, a_log: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t−1} + b_t over seq axis 1 from the carried state h0
    (B, W), which enters as a first step with a = 1. a_log: log a_t (f32)."""
    a_log = torch.cat([torch.zeros_like(a_log[:, :1]), a_log], dim=1)
    b = torch.cat([h0[:, None].to(b.dtype), b], dim=1)
    h = rglru_scan_ref(a_log, b)[0][:, 1:]
    return h, h[:, -1]


_CHANNELS = P(BATCH, None, "model")     # (B, S, W): the batch, the channels over "model"


def apply_rglru(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → (out, new_state {lru (B,W) f32, conv (B,K−1,W)})."""
    B, S, _ = x.shape
    x = maybe_shard(x, P(BATCH, None, None))    # under a mesh: the sequence whole
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")
    proj = x @ p["w_in"]
    tail = state["conv"] if state is not None else None
    u = _conv_causal(proj, p["conv_w"], tail)
    K = cfg.conv_width
    hist = proj if tail is None else torch.cat([tail, proj], dim=1)
    if hist.shape[1] < K - 1:
        padz = replicate_like(torch.zeros((B, K - 1 - hist.shape[1], hist.shape[2]),
                                          dtype=hist.dtype, device=hist.device), hist)
        hist = torch.cat([padz, hist], dim=1)
    new_conv = hist[:, -(K - 1):]

    # under a mesh the gates' products (their contraction over "model", a
    # pending sum) are laid out as the scan takes them, the channels over
    # "model": DTensor's own pointwise strategy carried them out over the
    # sequence, and on the (2, 16, 16) mesh wx's weight gradient then
    # refused the sequence-sharded tokens
    r = torch.sigmoid(maybe_shard(u @ p["wa"], _CHANNELS).float() + p["ba"])
    i = torch.sigmoid(maybe_shard(u @ p["wx"], _CHANNELS).float() + p["bx"])
    a_log = -_C * F.softplus(p["lam"]) * r                          # (B,S,W) f32
    xg = i * u.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * a_log), min=1e-12)) * xg
    if state is None:
        h, h_last = ops.rglru_scan(a_log, b)
    else:
        h, h_last = _rglru_scan(b, a_log, state["lru"])
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, {"lru": h_last, "conv": new_conv}


def rglru_state_shape(cfg: ArchConfig, batch: int, dtype):
    w = cfg.lru_dim
    return {"lru": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w), dtype)}
