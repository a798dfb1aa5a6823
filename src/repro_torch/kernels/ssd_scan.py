"""Mamba-2 SSD chunked scan: CUDA kernel wrapper, launch counter and plain
PyTorch version.

Replaces the Pallas TPU kernel ``_ssd_kernel`` in
``src/repro/kernels/ssd_scan.py``; the kernel itself is
``csrc/ssd_scan.cu``, whose header says what bounds it on an H100 and what
its design does about that.

``ssd_scan`` launches the kernel for CUDA tensors (or raises) and takes
``ssd_chunked``, a copy of ``repro.models.ssm.ssd_chunked``, for CPU
tensors. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i] (-inf j>i)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum over (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (all chunks at once). x (B,S,H,P) pre-scaled by dt;
    a_log (B,S,H) per-step log-decay; b, c (B,S,G,N), H % G == 0. Sums in
    float32 (the JAX einsums promote the bf16 operands to float32). Returns
    (y (B,S,H,P) in x's type, final state (B,H,P,N) float32)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    rep = H // G
    f32 = torch.float32
    xb = x.to(f32).reshape(B, nc, chunk, H, P)
    ab = a_log.to(f32).reshape(B, nc, chunk, H).permute(0, 3, 1, 2)    # (B,H,nc,l)
    cb_h = c.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    bb_h = b.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    a_cum = torch.cumsum(ab, dim=-1)                                     # (B,H,nc,l)
    # intra-chunk (quadratic, "attention-like" dual form)
    lmat = torch.exp(_segsum(ab))                                        # (B,H,nc,l,s)
    scores = torch.einsum("bclhn,bcshn->bhcls", cb_h, bb_h) * lmat
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xb)
    # chunk-final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)                    # (B,H,nc,l)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          bb_h * decay_states.permute(0, 2, 3, 1)[..., None], xb)
    # inter-chunk recurrence: h_{c+1} = exp(sum a_c) h_c + states_c
    chunk_decay = torch.exp(a_cum[..., -1]).permute(0, 2, 1)             # (B,nc,H)
    run = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    prev = []
    for i in range(nc):
        prev.append(run)
        run = chunk_decay[:, i, :, None, None] * run + states[:, i]
    prev_states = torch.stack(prev, dim=1)                               # (B,nc,H,P,N)
    # inter-chunk contribution
    state_decay = torch.exp(a_cum).permute(0, 2, 3, 1)                   # (B,nc,l,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cb_h, prev_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(B, S, H, P).to(x.dtype)
    return y, run


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); a_log (B,S,H) float32; b, c (B,S,G,N) -> (y (B,S,H,P) in
    x's type, final state (B,H,P,N) float32). ``chunk`` is clamped to S and
    must divide it."""
    B, S, H, P = x.shape
    chunk = min(chunk, S)
    if not x.is_cuda:
        return ssd_chunked(x, a_log, b, c, chunk)
    G, N = b.shape[2], b.shape[3]
    if not all(t.is_cuda and t.device == x.device for t in (a_log, b, c)):
        raise ValueError("ssd_scan: x, a_log, b and c must lie on one CUDA device")
    if x.dtype not in _DTYPES or not x.dtype == b.dtype == c.dtype \
            or a_log.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dtype x {x.dtype}, b {b.dtype}, c {c.dtype}, a_log "
                         f"{a_log.dtype} not supported (x, b, c float32 or bfloat16, all "
                         "alike; a_log float32)")
    if (tuple(a_log.shape) != (B, S, H) or b.shape != c.shape or b.shape[:2] != (B, S)
            or G == 0 or H % G):
        raise ValueError(f"ssd_scan: shapes x{tuple(x.shape)} a_log{tuple(a_log.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)} do not agree")
    if P % 16 or not 0 < P <= MAX_P or N % 16 or not 0 < N <= MAX_N:
        raise ValueError(f"ssd_scan: head dim P={P} / state N={N} not supported (multiples "
                         f"of 16 up to {MAX_P} / {MAX_N})")
    if S == 0 or S % chunk or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: seq {S} with chunk {chunk} not supported (chunk divides "
                         f"seq, at most {MAX_CHUNK})")
    x, a_log, b, c = x.contiguous(), a_log.contiguous(), b.contiguous(), c.contiguous()
    if any(t.data_ptr() % 16 for t in (x, b, c)):
        raise ValueError("ssd_scan: x, b and c must be 16-byte aligned")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.ssd_scan_fwd(x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
                           y.data_ptr(), state.data_ptr(), B, S, H, P, G, N, chunk,
                           _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("ssd_scan kernel: " + lib.ssd_scan_error_string(err).decode())
    global launches
    launches += 1
    return y, state
