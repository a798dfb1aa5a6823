"""Mamba-2 SSD chunked scan: CUDA kernel wrapper, launch counter and plain
PyTorch version.

Replaces the Pallas TPU kernel ``_ssd_kernel`` in
``src/repro/kernels/ssd_scan.py``; the kernel itself is
``csrc/ssd_scan.cu``, whose header says what bounds it on an H100 and what
its design does about that.

``ssd_scan`` launches the kernels for CUDA tensors (or raises) and takes
``ssd_chunked``, a copy of ``repro.models.ssm.ssd_chunked``, for CPU
tensors. In bfloat16 it launches four stages, the SSD paper's chunk-parallel
decomposition (arXiv:2405.21060): ``cb_kernel``, ``chunk_state_kernel``,
``state_passing_kernel`` and ``chunk_scan_kernel``, whose plain versions
``ssd_cb``, ``ssd_chunk_state``, ``ssd_state_passing`` and
``ssd_chunk_scan`` compose ``ssd_chunked``. In float32 it launches one
kernel on the CUDA cores. ``launches`` counts one for each ``ssd_scan``
call that reaches the card, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from ._guard import require_no_grad

MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128
TILE = 64                     # rows of a cb tile and of a chunk_scan query tile
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _seg_from_cum(a_cum: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = a_cum[..., i] - a_cum[..., j] (-inf j>i)."""
    L = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]    # sum over (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a_cum.device))
    return torch.where(mask, diff, float("-inf"))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i] (-inf j>i)."""
    return _seg_from_cum(torch.cumsum(a, dim=-1))


def ssd_cb(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """Stage 1: C_c B_c^T of each chunk and group, (B, nc, G, L, L) float32."""
    B, S, G, N = b.shape
    nc = S // chunk
    bb = b.to(torch.float32).reshape(B, nc, chunk, G, N)
    cc = c.to(torch.float32).reshape(B, nc, chunk, G, N)
    return torch.einsum("bclgn,bcsgn->bcgls", cc, bb)


def ssd_chunk_state(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: each chunk's own final state from zero, (X * w)^T B with
    w = exp(a_cum[-1] - a_cum), (B, nc, H, P, N) float32; and a_cum, the
    in-chunk cumulative log-decay, (B, H, nc, L) float32."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = S // chunk
    xb = x.to(torch.float32).reshape(B, nc, chunk, H, P)
    ab = a_log.to(torch.float32).reshape(B, nc, chunk, H).permute(0, 3, 1, 2)   # (B,H,nc,l)
    bb_h = b.to(torch.float32).reshape(B, nc, chunk, G, N).repeat_interleave(H // G, dim=3)
    a_cum = torch.cumsum(ab, dim=-1)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)                    # (B,H,nc,l)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          bb_h * decay_states.permute(0, 2, 3, 1)[..., None], xb)
    return states, a_cum


def ssd_state_passing(states: torch.Tensor, a_cum: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 3: the inter-chunk recurrence h_{c+1} = exp(a_cum_c[-1]) h_c +
    states_c from ``h0`` (zero if None). Returns (prev (B, nc, H, P, N), the
    state entering each chunk; the final state (B, H, P, N)), float32."""
    B, nc, H, P, N = states.shape
    chunk_decay = torch.exp(a_cum[..., -1]).permute(0, 2, 1)             # (B,nc,H)
    run = torch.zeros((B, H, P, N), dtype=torch.float32, device=states.device) \
        if h0 is None else h0.to(torch.float32)
    prev = []
    for i in range(nc):
        prev.append(run)
        run = chunk_decay[:, i, :, None, None] * run + states[:, i]
    return torch.stack(prev, dim=1), run


def ssd_chunk_scan(x: torch.Tensor, a_cum: torch.Tensor, c: torch.Tensor, cb: torch.Tensor,
                   prev: torch.Tensor) -> torch.Tensor:
    """Stage 4: y = (tril(exp(a_cum_i - a_cum_j)) o CB) X + exp(a_cum) C prev^T
    for every chunk, from ``cb`` (B, nc, G, L, L) and ``prev`` (B, nc, H, P,
    N). Sums in float32; y (B, S, H, P) in x's type."""
    B, S, H, P = x.shape
    G, N = c.shape[2], c.shape[3]
    nc, chunk = a_cum.shape[2], a_cum.shape[3]
    rep = H // G
    f32 = torch.float32
    xb = x.to(f32).reshape(B, nc, chunk, H, P)
    cc_h = c.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    # intra-chunk (quadratic, "attention-like" dual form)
    lmat = torch.exp(_seg_from_cum(a_cum))                               # (B,H,nc,l,s)
    scores = cb.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3, 4) * lmat
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xb)
    # inter-chunk contribution
    state_decay = torch.exp(a_cum).permute(0, 2, 3, 1)                   # (B,nc,l,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cc_h, prev.to(f32)) * state_decay[..., None]
    return (y_diag + y_off).reshape(B, S, H, P).to(x.dtype)


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (all chunks at once), the four stages in turn. x
    (B,S,H,P) pre-scaled by dt; a_log (B,S,H) per-step log-decay; b, c
    (B,S,G,N), H % G == 0. Sums in float32 (the JAX einsums promote the bf16
    operands to float32). Returns (y (B,S,H,P) in x's type, final state
    (B,H,P,N) float32)."""
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} not divisible by chunk {chunk}")
    cb = ssd_cb(b, c, chunk)
    states, a_cum = ssd_chunk_state(x, a_log, b, chunk)
    prev, final = ssd_state_passing(states, a_cum, h0)
    return ssd_chunk_scan(x, a_cum, c, cb, prev), final


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("ssd_scan_f32_fwd", [ptr] * 6 + [i] * 7 + [ptr]),
                       ("ssd_cb_fwd", [ptr] * 3 + [i] * 5 + [ptr]),
                       ("ssd_chunk_state_fwd", [ptr] * 5 + [i] * 7 + [ptr]),
                       ("ssd_state_passing_fwd", [ptr] * 4 + [i] * 6 + [ptr]),
                       ("ssd_chunk_scan_fwd", [ptr] * 6 + [i] * 7 + [ptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, *args, like: torch.Tensor) -> None:
    lib = _lib()
    err = getattr(lib, name)(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan {name}: " + lib.ssd_scan_error_string(err).decode())


def _padded(chunk: int) -> int:
    """Rows and columns of a chunk's cb block: the chunk rounded up to 64."""
    return -(-chunk // TILE) * TILE


# The bfloat16 stages on the card, in the order ``ssd_scan`` launches them.
# Each takes contiguous CUDA tensors of the types ``ssd_scan`` checks and
# allocates its outputs; they count no launch (``ssd_scan`` counts one a call).
def cb_kernel(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """``ssd_cb`` on the tensor cores: (B, nc, G, LP, LP) float32, LP =
    chunk rounded up to 64, only the 64x64 tiles at or below the diagonal
    written (rows and columns past the chunk are zero there)."""
    B, S, G, N = b.shape
    lp = _padded(chunk)
    cb = torch.empty((B, S // chunk, G, lp, lp), dtype=torch.float32, device=b.device)
    _call("ssd_cb_fwd", b.data_ptr(), c.data_ptr(), cb.data_ptr(), B, S, G, N, chunk, like=b)
    return cb


def chunk_state_kernel(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunk_state``: (states (B, nc, H, P, N), a_cum (B, H, nc, L)), float32."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = S // chunk
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    a_cum = torch.empty((B, H, nc, chunk), dtype=torch.float32, device=x.device)
    _call("ssd_chunk_state_fwd", x.data_ptr(), a_log.data_ptr(), b.data_ptr(),
          states.data_ptr(), a_cum.data_ptr(), B, S, H, P, G, N, chunk, like=x)
    return states, a_cum


def state_passing_kernel(states: torch.Tensor, a_cum: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_state_passing`` from zero: (prev (B, nc, H, P, N) bfloat16, the
    final state (B, H, P, N) float32)."""
    B, nc, H, P, N = states.shape
    prev = torch.empty(states.shape, dtype=torch.bfloat16, device=states.device)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=states.device)
    _call("ssd_state_passing_fwd", states.data_ptr(), a_cum.data_ptr(), prev.data_ptr(),
          final.data_ptr(), B, nc, H, P, N, a_cum.shape[3], like=states)
    return prev, final


def chunk_scan_kernel(x: torch.Tensor, a_cum: torch.Tensor, c: torch.Tensor, cb: torch.Tensor,
                      prev: torch.Tensor) -> torch.Tensor:
    """``ssd_chunk_scan`` with ``cb`` as ``cb_kernel`` lays it out and
    ``prev`` in bfloat16: y (B, S, H, P) bfloat16."""
    B, S, H, P = x.shape
    G, N = c.shape[2], c.shape[3]
    y = torch.empty_like(x)
    _call("ssd_chunk_scan_fwd", x.data_ptr(), a_cum.data_ptr(), c.data_ptr(), cb.data_ptr(),
          prev.data_ptr(), y.data_ptr(), B, S, H, P, G, N, a_cum.shape[3], like=x)
    return y


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); a_log (B,S,H) float32; b, c (B,S,G,N) -> (y (B,S,H,P) in
    x's type, final state (B,H,P,N) float32). ``chunk`` is clamped to S and
    must divide it. bfloat16 runs the four stages on the tensor cores,
    float32 the CUDA-core kernel."""
    B, S, H, P = x.shape
    chunk = min(chunk, S)
    if not x.is_cuda:
        return ssd_chunked(x, a_log, b, c, chunk)
    require_no_grad("ssd_scan", "'Backward kernels'", x, a_log, b, c)
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
    if x.dtype == torch.bfloat16:
        cb = cb_kernel(b, c, chunk)
        states, a_cum = chunk_state_kernel(x, a_log, b, chunk)
        prev, state = state_passing_kernel(states, a_cum)
        y = chunk_scan_kernel(x, a_cum, c, cb, prev)
    else:
        y = torch.empty_like(x)
        state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        _call("ssd_scan_f32_fwd", x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
              y.data_ptr(), state.data_ptr(), B, S, H, P, G, N, chunk, like=x)
    global launches
    launches += 1
    return y, state
