"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block (PyTorch
counterpart of ``repro.models.ssm``).

Chunked SSD following the paper's ``ssd_minimal`` (quadratic intra-chunk,
linear inter-chunk state passing); ``ssd_chunked`` lives beside the CUDA
kernel in ``repro_torch.kernels.ssd_scan`` as its plain version. Decode is
the O(1) recurrent update carrying (B, H, P, N) state and a conv tail. The
functions here are pure, as the JAX package's are: the transformer writes
the returned state into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ssd_scan import _segsum, ssd_chunked
from .common import dense_init, rms_norm
from .config import ArchConfig
from .sharding_utils import BATCH, P, is_dtensor, maybe_shard, replicate_like

__all__ = ["_segsum", "ssd_chunked", "ssd_scanned", "init_mamba2", "_causal_conv",
           "apply_mamba2", "apply_mamba2_decode", "mamba2_state_shape"]


def ssd_scanned(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-over-chunks SSD (same math as ``ssd_chunked``): only one
    chunk's (l, l) decay matrix is live at a time."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    rep = H // G
    f32 = torch.float32
    xb = x.to(f32).reshape(B, nc, chunk, H, P)
    ab = a_log.to(f32).reshape(B, nc, chunk, H).permute(0, 1, 3, 2)    # (B,nc,H,l)
    bb = b.to(f32).reshape(B, nc, chunk, G, N)
    cb = c.to(f32).reshape(B, nc, chunk, G, N)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    ys = []
    for i in range(nc):
        xc, ac = xb[:, i], ab[:, i]                          # (B,l,H,P) (B,H,l)
        cb_h = cb[:, i].repeat_interleave(rep, dim=2)        # (B,l,H,N)
        bb_h = bb[:, i].repeat_interleave(rep, dim=2)
        a_cum = torch.cumsum(ac, dim=-1)                     # (B,H,l)
        seg = a_cum[..., :, None] - a_cum[..., None, :]
        lmat = torch.where(mask, torch.exp(seg), 0.0)        # (B,H,l,l)
        scores = torch.einsum("blhn,bshn->bhls", cb_h, bb_h) * lmat
        y_diag = torch.einsum("bhls,bshp->blhp", scores, xc)
        y_off = torch.einsum("blhn,bhpn->blhp", cb_h, state) \
            * torch.exp(a_cum).transpose(1, 2)[..., None]
        decay = torch.exp(a_cum[..., -1:] - a_cum)           # (B,H,l)
        add = torch.einsum("blhn,blhp->bhpn", bb_h * decay.transpose(1, 2)[..., None], xc)
        state = torch.exp(a_cum[..., -1])[..., None, None] * state + add
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, P), state


# -- full block ---------------------------------------------------------------------
def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype,
                lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = din + 2 * g * n
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, 2 * din + 2 * g * n + h), dtype, lead=lead),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), dtype, fan_in=cfg.ssm_conv,
                             lead=lead),
        "a_log": torch.zeros(lead + (h,), device=dev),          # A = -exp(a_log) in [-1, 0)
        "dt_bias": torch.zeros(lead + (h,), device=dev),
        "d_skip": torch.ones(lead + (h,), device=dev),
        "norm_scale": torch.zeros(lead + (din,), device=dev),
        "out_proj": dense_init(gen, (din, d), dtype, fan_in=din, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as the sum of shifted products (no cuDNN).
    x: (B, S, C); w: (K, C); tail: (B, K-1, C)."""
    K = w.shape[0]
    pad = replicate_like(torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                                     device=x.device), x) if tail is None else tail
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    return F.silu(out)


def _split(proj: torch.Tensor, cfg: ArchConfig):
    din, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(proj, [din, din, gn, gn, cfg.ssm_nheads], dim=-1)


def apply_mamba2(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → (out, new_state {ssm (B,H,P,N) f32, conv (B,K-1,C)}).
    ``state`` None runs the chunked scan from zero state: on a CUDA tensor
    the ``ssd_scan`` kernel, on the CPU ``ssd_scanned`` above 4 chunks and
    ``ssd_chunked`` otherwise."""
    B, S, D = x.shape
    din, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    pdim = cfg.ssm_headdim
    x = maybe_shard(x, P(BATCH, None, None))    # under a mesh: the sequence whole
    proj = x @ p["in_proj"]
    z, xc, bc, cc, dt = _split(proj, cfg)
    conv_in = torch.cat([xc, bc, cc], dim=-1)
    tail = state["conv"] if state is not None else None
    conv_out = _causal_conv(conv_in, p["conv_w"], tail)
    K = cfg.ssm_conv
    hist = conv_in if tail is None else torch.cat([tail, conv_in], dim=1)
    if hist.shape[1] < K - 1:       # very short prefill: left-pad with zeros
        pad = replicate_like(torch.zeros((B, K - 1 - hist.shape[1], hist.shape[2]),
                                         dtype=hist.dtype, device=hist.device), hist)
        hist = torch.cat([pad, hist], dim=1)
    new_conv = hist[:, -(K - 1):]
    xc, bc, cc = torch.split(conv_out, [din, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                      # (B,S,H)
    a = -torch.exp(p["a_log"])                                      # (H,)
    a_log_steps = dt * a                                            # (B,S,H) ≤ 0
    xh = xc.reshape(B, S, h, pdim)
    xdt = xh * dt[..., None].to(x.dtype)
    bmat = bc.reshape(B, S, g, n)
    cmat = cc.reshape(B, S, g, n)

    h0 = state["ssm"] if state is not None else None
    chunk = min(cfg.ssm_chunk, S)
    if h0 is None and S % chunk == 0:
        if x.is_cuda or is_dtensor(x):      # a DTensor: each rank's rows (ops.ssd_scan)
            y, hfin = ops.ssd_scan(xdt, a_log_steps, bmat, cmat, chunk=chunk)
        elif S // chunk > 4:
            # long sequences: sequential chunk scan — one (l, l) decay
            # matrix live at a time instead of all nc at once
            y, hfin = ssd_scanned(xdt, a_log_steps, bmat, cmat, chunk, h0)
        else:
            y, hfin = ssd_chunked(xdt, a_log_steps, bmat, cmat, chunk)
    elif S % chunk == 0 and S // chunk > 4:
        y, hfin = ssd_scanned(xdt, a_log_steps, bmat, cmat, chunk, h0)
    else:
        y, hfin = ssd_chunked(xdt, a_log_steps, bmat, cmat, chunk, h0=h0)
    y = y + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, din)
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"], {"ssm": hfin, "conv": new_conv}


def apply_mamba2_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                        state: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update (no kernel). x: (B, 1, D)."""
    B, S, D = x.shape
    din, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    pdim = cfg.ssm_headdim
    proj = x @ p["in_proj"]
    z, xc, bc, cc, dt = _split(proj, cfg)
    conv_in = torch.cat([xc, bc, cc], dim=-1)                       # (B,1,C)
    window = torch.cat([state["conv"], conv_in], dim=1)             # (B,K,C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]))[:, None]
    new_conv = window[:, 1:]
    xc, bc, cc = torch.split(conv_out, [din, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                # (B,H)
    a = torch.exp(dt * -torch.exp(p["a_log"]))                      # (B,H)
    xh = xc.reshape(B, h, pdim)
    bmat = bc.reshape(B, g, n).repeat_interleave(h // g, dim=1)     # (B,H,N)
    cmat = cc.reshape(B, g, n).repeat_interleave(h // g, dim=1)
    hs = state["ssm"].float()
    hs = a[..., None, None] * hs + (dt[..., None] * xh.float())[..., None] \
        * bmat[:, :, None, :].float()
    y = torch.einsum("bhpn,bhn->bhp", hs, cmat.float()).to(x.dtype)
    y = y + xh * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(B, 1, din)
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"], {"ssm": hs.to(state["ssm"].dtype), "conv": new_conv}


def mamba2_state_shape(cfg: ArchConfig, batch: int, dtype):
    h, pdim, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {"ssm": ((batch, h, pdim, n), torch.float32),
            "conv": ((batch, cfg.ssm_conv - 1, conv_dim), dtype)}
