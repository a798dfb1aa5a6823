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

The gradient has no Pallas kernel: the JAX package differentiates
``ssd_chunked`` (``src/repro/models/ssm.py:28``). On the card ``ssd_scan`` is
differentiable through ``SsdScanFn``, whose backward is ``ssd_scan_bwd``: the
kernels of ``csrc/ssd_scan_bwd.cu``, counted in ``bwd_launches`` (one a
call). ``ssd_scan_bwd_ref`` is its plain version, the four stages' adjoints
in reverse order written out, with no autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128
TILE = 64                     # rows of a cb tile and of a chunk_scan query tile
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0
bwd_launches = 0


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


def ssd_scan_bwd_ref(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of ``ssd_chunked`` from zero state: the cotangents dy
    of y (B,S,H,P) and ``dstate`` of the final state (B,H,P,N; None for
    zero) -> (dx, da_log, db, dc) in the types of x, a_log, b, c. The
    adjoints of the four stages in reverse: chunk_scan's, state passing as
    a reverse scan over the chunks, chunk_state's, cb's; then the in-chunk
    cumulative sum's. Sums in float32; no autograd."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc, L, rep = S // chunk, chunk, H // G
    f32 = torch.float32
    xb = x.to(f32).reshape(B, nc, L, H, P)
    dyb = dy.to(f32).reshape(B, nc, L, H, P)
    bb = b.to(f32).reshape(B, nc, L, G, N).repeat_interleave(rep, dim=3)      # (B,nc,l,H,N)
    cc = c.to(f32).reshape(B, nc, L, G, N).repeat_interleave(rep, dim=3)
    cb = ssd_cb(b, c, chunk).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3, 4)  # (B,H,nc,l,s)
    states, a_cum = ssd_chunk_state(x, a_log, b, chunk)                        # a_cum (B,H,nc,l)
    prev, _ = ssd_state_passing(states, a_cum)
    # chunk_scan's adjoint, diagonal blocks: y_i = sum_j lmat_ij cb_ij x_j
    lmat = torch.exp(_seg_from_cum(a_cum))                                     # (B,H,nc,l,s)
    d_scores = torch.einsum("bclhp,bcshp->bhcls", dyb, xb) * lmat              # d cb, per head
    t = d_scores * cb                                                          # d (a_cum_i - a_cum_j)
    d_cum = t.sum(-1) - t.sum(-2)                                              # (B,H,nc,l)
    dx = torch.einsum("bhcls,bclhp->bcshp", cb * lmat, dyb)
    dc_h = torch.einsum("bhcls,bcshn->bclhn", d_scores, bb)
    db_h = torch.einsum("bhcls,bclhn->bcshn", d_scores, cc)
    # off-diagonal: y_i += exp(a_cum_i) C_i prev^T
    ea = torch.exp(a_cum).permute(0, 2, 3, 1)                                  # (B,nc,l,H)
    dc_off = torch.einsum("bclhp,bchpn->bclhn", dyb, prev) * ea[..., None]
    dc_h = dc_h + dc_off
    d_cum = d_cum + torch.einsum("bclhn,bclhn->bhcl", dc_off, cc)
    d_prev = torch.einsum("bclhp,bclhn->bchpn", dyb * ea[..., None], cc)       # (B,nc,H,P,N)
    # state passing in reverse: prev_{c+1} = decay_c prev_c + states_c
    decay = torch.exp(a_cum[..., -1]).permute(0, 2, 1)                         # (B,nc,H)
    g = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if dstate is None \
        else dstate.to(f32)
    d_states, d_decay = [None] * nc, [None] * nc
    for i in reversed(range(nc)):
        d_states[i] = g
        d_decay[i] = (g * prev[:, i]).sum((-1, -2)) * decay[:, i]              # (B,H)
        g = d_prev[:, i] + decay[:, i, :, None, None] * g
    d_st = torch.stack(d_states, dim=1)                                        # (B,nc,H,P,N)
    d_cum[..., -1] += torch.stack(d_decay, dim=-1)
    # chunk_state's adjoint: states = sum_j w_j x_j (x) B_j, w = exp(a_cum[-1] - a_cum)
    w = torch.exp(a_cum[..., -1:] - a_cum)                                     # (B,H,nc,l)
    wl = w.permute(0, 2, 3, 1)[..., None]                                      # (B,nc,l,H,1)
    z = torch.einsum("bclhn,bchpn->bclhp", bb, d_st)
    dx = dx + z * wl
    db_h = db_h + torch.einsum("bclhp,bchpn->bclhn", xb, d_st) * wl
    wdw = w * (xb * z).sum(-1).permute(0, 3, 1, 2)                             # (B,H,nc,l)
    d_cum = d_cum - wdw
    d_cum[..., -1] += wdw.sum(-1)
    # the in-chunk cumulative sum's adjoint: a reverse cumulative sum
    da = d_cum.flip(-1).cumsum(-1).flip(-1).permute(0, 2, 3, 1).reshape(B, S, H)
    db = db_h.reshape(B, nc, L, G, rep, N).sum(4).reshape(B, S, G, N)
    dc = dc_h.reshape(B, nc, L, G, rep, N).sum(4).reshape(B, S, G, N)
    return (dx.reshape(B, S, H, P).to(x.dtype), da.to(a_log.dtype), db.to(b.dtype),
            dc.to(c.dtype))


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [ptr] * 17 + [i] * 8 + [ptr]
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_error_string.argtypes = [i]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
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


def _check(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           chunk: int, what: str = "ssd_scan") -> None:
    """Raise on inputs the kernels do not take."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if not all(t.is_cuda and t.device == x.device for t in (a_log, b, c)):
        raise ValueError(f"{what}: x, a_log, b and c must lie on one CUDA device")
    if x.dtype not in _DTYPES or not x.dtype == b.dtype == c.dtype \
            or a_log.dtype != torch.float32:
        raise ValueError(f"{what}: dtype x {x.dtype}, b {b.dtype}, c {c.dtype}, a_log "
                         f"{a_log.dtype} not supported (x, b, c float32 or bfloat16, all "
                         "alike; a_log float32)")
    if (tuple(a_log.shape) != (B, S, H) or b.shape != c.shape or b.shape[:2] != (B, S)
            or G == 0 or H % G):
        raise ValueError(f"{what}: shapes x{tuple(x.shape)} a_log{tuple(a_log.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)} do not agree")
    if P % 16 or not 0 < P <= MAX_P or N % 16 or not 0 < N <= MAX_N:
        raise ValueError(f"{what}: head dim P={P} / state N={N} not supported (multiples "
                         f"of 16 up to {MAX_P} / {MAX_N})")
    if S == 0 or S % chunk or chunk > MAX_CHUNK:
        raise ValueError(f"{what}: seq {S} with chunk {chunk} not supported (chunk divides "
                         f"seq, at most {MAX_CHUNK})")


def _forward(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels on checked, contiguous CUDA tensors (one count)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
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


class SsdScanFn(torch.autograd.Function):
    """The card's SSD scan with its gradient: the forward kernels with the
    inputs saved, ``ssd_scan_bwd`` for (dx, da_log, db, dc). A cotangent
    that autograd leaves out (the final state's when only y is used, or
    y's when only the state is) is read as zero."""

    @staticmethod
    def forward(ctx, x, a_log, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, a_log, b, c)
        ctx.chunk = chunk
        return _forward(x, a_log, b, c, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, a_log, b, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*ssd_scan_bwd(x, a_log, b, c, dy, dstate, chunk=ctx.chunk), None)


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); a_log (B,S,H) float32; b, c (B,S,G,N) -> (y (B,S,H,P) in
    x's type, final state (B,H,P,N) float32). ``chunk`` is clamped to S and
    must divide it. bfloat16 runs the four stages on the tensor cores,
    float32 the CUDA-core kernel. Differentiable on the card (``SsdScanFn``)."""
    S = x.shape[1]
    chunk = min(chunk, S)
    if not x.is_cuda:
        return ssd_chunked(x, a_log, b, c, chunk)
    _check(x, a_log, b, c, chunk)
    x, a_log, b, c = x.contiguous(), a_log.contiguous(), b.contiguous(), c.contiguous()
    return SsdScanFn.apply(x, a_log, b, c, chunk)


def ssd_scan_bwd(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dy: torch.Tensor, dstate: Optional[torch.Tensor] = None, *, chunk: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, da_log, db, dc) of ``ssd_scan`` from zero state, from its inputs,
    the cotangent ``dy`` of y and ``dstate`` of the final state (None for
    zero); in the types of x, a_log, b, c. CUDA tensors launch the backward
    kernels (one count a call), CPU tensors take ``ssd_scan_bwd_ref``. db and
    dc are summed over a group's heads with f32 atomics, in an order that
    changes from run to run: not bit-reproducible."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    chunk = min(chunk, S)
    if not x.is_cuda:
        return ssd_scan_bwd_ref(x, a_log, b, c, dy, dstate, chunk)
    _check(x, a_log, b, c, chunk, "ssd_scan_bwd")
    if dy.shape != x.shape or not dy.is_cuda or dy.device != x.device or (
            dstate is not None and (tuple(dstate.shape) != (B, H, P, N)
                                    or dstate.device != x.device)):
        raise ValueError(f"ssd_scan_bwd: dy{tuple(dy.shape)} / dstate "
                         f"{None if dstate is None else tuple(dstate.shape)} do not match "
                         f"x{tuple(x.shape)}, state ({B}, {H}, {P}, {N})")
    x, a_log, b, c = (t.detach().contiguous() for t in (x, a_log, b, c))
    dy = dy.to(x.dtype).contiguous()
    dstate = None if dstate is None else dstate.to(torch.float32).contiguous()
    nc, f32 = S // chunk, dict(dtype=torch.float32, device=x.device)
    # f32 scratch: a_cum, the chunk states (then their cotangents), the state
    # entering each chunk, dy's share of its cotangent, d(chunk decay)
    a_cum = torch.empty((B, H, nc, chunk), **f32)
    states, prev, d_prev = (torch.empty((B, nc, H, P, N), **f32) for _ in range(3))
    d_decay = torch.empty((B, H, nc), **f32)
    dx, da = torch.empty_like(x), torch.empty((B, S, H), **f32)
    # db and dc are summed over the heads of a group in f32 (zeroed by the first kernel)
    db32, dc32 = torch.empty(b.shape, **f32), torch.empty(c.shape, **f32)
    db, dc = (db32, dc32) if x.dtype == torch.float32 else (torch.empty_like(b),
                                                            torch.empty_like(c))
    lib = _bwd_lib()
    err = lib.ssd_scan_bwd(
        x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
        0 if dstate is None else dstate.data_ptr(), a_cum.data_ptr(), states.data_ptr(),
        prev.data_ptr(), d_prev.data_ptr(), d_decay.data_ptr(), dx.data_ptr(), da.data_ptr(),
        db32.data_ptr(), dc32.data_ptr(), db.data_ptr(), dc.data_ptr(), B, S, H, P, G, N,
        chunk, _DTYPES.index(x.dtype), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("ssd_scan_bwd kernels: " + lib.ssd_scan_bwd_error_string(err).decode())
    global bwd_launches
    bwd_launches += 1
    return dx, da, db, dc
