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
in reverse order written out, with no autograd. In bfloat16 the backward
launches six stages on the tensor cores, ``bwd_chunk_state_kernel``,
``bwd_state_passing_kernel``, ``bwd_dcb_kernel``, ``bwd_dx_kernel``,
``bwd_dbdc_kernel`` and ``bwd_da_kernel``, whose plain versions
``ssd_bwd_chunk_state`` ... ``ssd_bwd_da`` compose to ``ssd_scan_bwd_ref``;
it sums db and dc over a group's heads in a fixed order, so every output is
bit-reproducible. In float32 it launches three kernels on the CUDA cores,
which add db and dc with atomics (not bit-reproducible). None of these
launches moves ``launches``, the forward's count.

A tensor without data (fake or meta) takes the shape-only path
(``kernels/shape_only.py``): the outputs allocated as the card's call
allocates them (y, the final state; dx, da_log, db, dc), written by the
registered op that stands for the C entry points, through ``SsdScanFn`` so
a dry-run's backward takes it too. The stages' intermediates are not
allocated there. It launches nothing and counts nothing. Data-free tensors
on the card's device type get the card's checks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from . import shape_only as _shape
from ._guard import refuse_dtensor

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


# The backward's chunk-parallel decomposition, one plain stage per bf16 kernel
# of ``csrc/ssd_scan_bwd.cu``, in the order ``ssd_scan_bwd`` launches them.
# Sums in float32; they compose to ``ssd_scan_bwd_ref``.
def ssd_bwd_chunk_state(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, dy: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 1: each chunk's own state (X * w)^T B and dy's share of the
    cotangent of the state entering it, (dy * exp(a_cum))^T C, both (B, nc,
    H, P, N); and a_cum (B, H, nc, L)."""
    B, S, H, P = x.shape
    G, N = c.shape[2], c.shape[3]
    nc = S // chunk
    states, a_cum = ssd_chunk_state(x, a_log, b, chunk)
    dyb = dy.to(torch.float32).reshape(B, nc, chunk, H, P)
    cc_h = c.to(torch.float32).reshape(B, nc, chunk, G, N).repeat_interleave(H // G, dim=3)
    ea = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]                     # (B,nc,l,H,1)
    d_prev = torch.einsum("bclhp,bclhn->bchpn", dyb * ea, cc_h)
    return states, d_prev, a_cum


def ssd_bwd_state_passing(states: torch.Tensor, d_prev: torch.Tensor, a_cum: torch.Tensor,
                          dstate: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 2: the state recurrence forward from zero, then in reverse from
    ``dstate`` (zero if None): dst_c = g; g = d_prev_c + exp(a_cum_c[-1]) g.
    Returns (prev, dst) (B, nc, H, P, N) and d_last (B, H, nc) = <dst_c,
    prev_{c+1}>, the state's whole share of the cotangent of a_cum_c[-1]
    (prev_{nc} the final state)."""
    prev, final = ssd_state_passing(states, a_cum)
    B, nc, H, P, N = states.shape
    decay = torch.exp(a_cum[..., -1]).permute(0, 2, 1)                        # (B,nc,H)
    g = torch.zeros_like(final) if dstate is None else dstate.to(torch.float32)
    nxt = torch.cat([prev[:, 1:], final[:, None]], dim=1)                      # prev_{c+1}
    dst = [None] * nc
    for i in reversed(range(nc)):
        dst[i] = g
        g = d_prev[:, i] + decay[:, i, :, None, None] * g
    dst = torch.stack(dst, dim=1)
    return prev, dst, (dst * nxt).sum((-1, -2)).permute(0, 2, 1)


def ssd_bwd_dcb(x: torch.Tensor, dy: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                a_cum: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 3: cb = C B^T and dcb = sum over a group's heads of (dy X^T) o
    lmat, both (B, nc, G, L, L) (zero above the diagonal for dcb), lmat =
    tril(exp(a_cum_i - a_cum_j)); and each head's in-chunk share of d a_cum,
    the row sums less the column sums of t = (dy X^T) o lmat o cb, (B, H, nc, L)."""
    B, S, H, P = x.shape
    G = b.shape[2]
    nc, rep = S // chunk, H // G
    f32 = torch.float32
    cb = ssd_cb(b, c, chunk)
    lmat = torch.exp(_seg_from_cum(a_cum))                                    # (B,H,nc,l,s)
    d_s = torch.einsum("bclhp,bcshp->bhcls", dy.to(f32).reshape(B, nc, chunk, H, P),
                       x.to(f32).reshape(B, nc, chunk, H, P)) * lmat
    t = d_s * cb.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3, 4)
    dcb = d_s.reshape(B, G, rep, nc, chunk, chunk).sum(2).permute(0, 2, 1, 3, 4)
    return cb, dcb, t.sum(-1) - t.sum(-2)


def ssd_bwd_dx(dy: torch.Tensor, b: torch.Tensor, a_cum: torch.Tensor, cb: torch.Tensor,
               dst: torch.Tensor) -> torch.Tensor:
    """Stage 4: dx = (lmat o cb)^T dy + w o (B dst^T) per head, w =
    exp(a_cum[-1] - a_cum); (B, S, H, P) float32."""
    B, S, H, P = dy.shape
    G, N = b.shape[2], b.shape[3]
    nc, chunk = a_cum.shape[2], a_cum.shape[3]
    rep, f32 = H // G, torch.float32
    lmat = torch.exp(_seg_from_cum(a_cum))
    scores = cb.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3, 4) * lmat
    dx = torch.einsum("bhcls,bclhp->bcshp", scores, dy.to(f32).reshape(B, nc, chunk, H, P))
    bb_h = b.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    w = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 3, 1)[..., None]      # (B,nc,l,H,1)
    dx = dx + torch.einsum("bclhn,bchpn->bclhp", bb_h, dst) * w
    return dx.reshape(B, S, H, P)


def ssd_bwd_dbdc(x: torch.Tensor, dy: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 a_cum: torch.Tensor, dcb: torch.Tensor, prev: torch.Tensor,
                 dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 5: per group dC = dcb B + sum_h exp(a_cum) o (dy prev) and dB =
    dcb^T C + sum_h w o (X dst), (B, S, G, N) float32; and each head's state
    share of d a_cum, exp(a_cum) (dy prev) . C - w (X dst) . B, (B, H, nc, L)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, chunk = a_cum.shape[2], a_cum.shape[3]
    rep, f32 = H // G, torch.float32
    xb = x.to(f32).reshape(B, nc, chunk, H, P)
    dyb = dy.to(f32).reshape(B, nc, chunk, H, P)
    bb = b.to(f32).reshape(B, nc, chunk, G, N)
    cc = c.to(f32).reshape(B, nc, chunk, G, N)
    ea = torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]                     # (B,nc,l,H,1)
    w = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 3, 1)[..., None]
    q = torch.einsum("bclhp,bchpn->bclhn", dyb, prev) * ea                    # exp(a_cum) o dy prev
    r = torch.einsum("bclhp,bchpn->bclhn", xb, dst) * w                       # w o X dst
    dc = torch.einsum("bcgls,bcsgn->bclgn", dcb, bb) \
        + q.reshape(B, nc, chunk, G, rep, N).sum(4)
    db = torch.einsum("bcgls,bclgn->bcsgn", dcb, cc) \
        + r.reshape(B, nc, chunk, G, rep, N).sum(4)
    d_state = (q * cc.repeat_interleave(rep, dim=3)).sum(-1) \
        - (r * bb.repeat_interleave(rep, dim=3)).sum(-1)                       # (B,nc,l,H)
    return db.reshape(B, S, G, N), dc.reshape(B, S, G, N), d_state.permute(0, 3, 1, 2)


def ssd_bwd_da(d_intra: torch.Tensor, d_state: torch.Tensor, d_last: torch.Tensor
               ) -> torch.Tensor:
    """Stage 6: d a_cum = d_intra + d_state, plus d_last on each chunk's last
    step, summed back to da_log by a reverse cumulative sum in each chunk;
    (B, S, H) float32."""
    d = d_intra + d_state
    d[..., -1] += d_last
    B, H, nc, chunk = d.shape
    return d.flip(-1).cumsum(-1).flip(-1).permute(0, 2, 3, 1).reshape(B, nc * chunk, H)


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


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ssd_scan_bwd.cu``) with its entry points typed."""
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("ssd_scan_bwd_f32", [ptr] * 15 + [i] * 7 + [ptr]),
                       ("ssd_bwd_chunk_state", [ptr] * 8 + [i] * 7 + [ptr]),
                       ("ssd_bwd_state_passing", [ptr] * 7 + [i] * 6 + [ptr]),
                       ("ssd_bwd_dcb", [ptr] * 8 + [i] * 7 + [ptr]),
                       ("ssd_bwd_dx", [ptr] * 6 + [i] * 7 + [ptr]),
                       ("ssd_bwd_dbdc", [ptr] * 11 + [i] * 7 + [ptr]),
                       ("ssd_bwd_da", [ptr] * 4 + [i] * 6 + [ptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    lib.ssd_scan_bwd_error_string.argtypes = [i]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    return _bind_bwd(_build.load("ssd_scan_bwd"))


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


def _bwd_call(name: str, *args, like: torch.Tensor) -> None:
    lib = _bwd_lib()
    err = getattr(lib, name)(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd {name}: "
                           + lib.ssd_scan_bwd_error_string(err).decode())


def bwd_slices(P: int, N: int) -> int:
    """Blocks a (b, h) of ``bwd_state_passing_kernel``: 1024 elements of P*N each."""
    return -(-P * N // 1024)


def split_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` as bf16 hi, mid and lo stacked on a new axis -3 (their sum
    is ``t`` to ~2^-26 of each element): the layout of the backward's prev and
    dst."""
    parts = []
    for _ in range(3):
        parts.append(t.to(torch.bfloat16))
        t = t - parts[-1].float()
    return torch.stack(parts, dim=-3)


# The bfloat16 backward's stages on the card, in the order ``ssd_scan_bwd``
# launches them; inputs as ``ssd_scan_bwd`` passes them (contiguous, checked);
# each allocates its outputs and counts no launch.
def bwd_chunk_state_kernel(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, dy: torch.Tensor, chunk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_bwd_chunk_state``: (states, d_prev (B, nc, H, P, N), a_cum (B, H,
    nc, L)), float32."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, f32 = S // chunk, dict(dtype=torch.float32, device=x.device)
    states, d_prev = (torch.empty((B, nc, H, P, N), **f32) for _ in range(2))
    a_cum = torch.empty((B, H, nc, chunk), **f32)
    _bwd_call("ssd_bwd_chunk_state", x.data_ptr(), a_log.data_ptr(), b.data_ptr(),
              c.data_ptr(), dy.data_ptr(), states.data_ptr(), d_prev.data_ptr(),
              a_cum.data_ptr(), B, S, H, P, G, N, chunk, like=x)
    return states, d_prev, a_cum


def bwd_state_passing_kernel(states: torch.Tensor, d_prev: torch.Tensor, a_cum: torch.Tensor,
                             dstate: Optional[torch.Tensor]
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_bwd_state_passing``: (prev, dst as ``split_bf16`` lays them out,
    (B, nc, H, 3, P, N) bfloat16; d_last by slice, (B, H, nc, ``bwd_slices``)
    float32)."""
    B, nc, H, P, N = states.shape
    prev3, dst3 = (torch.empty((B, nc, H, 3, P, N), dtype=torch.bfloat16,
                               device=states.device) for _ in range(2))
    d_last = torch.empty((B, H, nc, bwd_slices(P, N)), dtype=torch.float32,
                         device=states.device)
    _bwd_call("ssd_bwd_state_passing", states.data_ptr(), d_prev.data_ptr(), a_cum.data_ptr(),
              0 if dstate is None else dstate.data_ptr(), prev3.data_ptr(), dst3.data_ptr(),
              d_last.data_ptr(), B, nc, H, P, N, a_cum.shape[3], like=states)
    return prev3, dst3, d_last


def bwd_dcb_kernel(x: torch.Tensor, dy: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   a_cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_bwd_dcb`` key-major: (cbT (B, nc, G, LP, LP) float32, dcbT (same)
    bfloat16, [j][i] = cb[i][j] and dcb[i][j], LP = chunk rounded up to 64,
    only the 64x64 tiles at or above the diagonal written; d_intra by slot,
    (B, H, nc, LP / 64, LP) float32, summing over the slots to ``ssd_bwd_dcb``'s)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, chunk = a_cum.shape[2], a_cum.shape[3]
    lp = _padded(chunk)
    cbT = torch.empty((B, nc, G, lp, lp), dtype=torch.float32, device=x.device)
    dcbT = torch.empty((B, nc, G, lp, lp), dtype=torch.bfloat16, device=x.device)
    d_intra = torch.empty((B, H, nc, lp // TILE, lp), dtype=torch.float32, device=x.device)
    _bwd_call("ssd_bwd_dcb", x.data_ptr(), dy.data_ptr(), b.data_ptr(), c.data_ptr(),
              a_cum.data_ptr(), cbT.data_ptr(), dcbT.data_ptr(), d_intra.data_ptr(), B, S, H, P,
              G, N, chunk, like=x)
    return cbT, dcbT, d_intra


def bwd_dx_kernel(dy: torch.Tensor, b: torch.Tensor, a_cum: torch.Tensor, cbT: torch.Tensor,
                  dst3: torch.Tensor) -> torch.Tensor:
    """``ssd_bwd_dx`` from ``bwd_dcb_kernel``'s cbT and the hi plane of dst3:
    dx (B, S, H, P) bfloat16."""
    B, S, H, P = dy.shape
    G, N = b.shape[2], b.shape[3]
    dx = torch.empty_like(dy)
    _bwd_call("ssd_bwd_dx", dy.data_ptr(), b.data_ptr(), a_cum.data_ptr(), cbT.data_ptr(),
              dst3.data_ptr(), dx.data_ptr(), B, S, H, P, G, N, a_cum.shape[3], like=dy)
    return dx


def bwd_dbdc_kernel(x: torch.Tensor, dy: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    a_cum: torch.Tensor, dcbT: torch.Tensor, prev3: torch.Tensor,
                    dst3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssd_bwd_dbdc``: (db, dc (B, S, G, N) bfloat16; d_state (B, H, nc, 2,
    LP) float32, dy prev's share in slot 0 and X dst's in slot 1, summing to
    ``ssd_bwd_dbdc``'s, rows past the chunk unwritten)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc, chunk = a_cum.shape[2], a_cum.shape[3]
    db, dc = torch.empty_like(b), torch.empty_like(c)
    d_state = torch.empty((B, H, nc, 2, _padded(chunk)), dtype=torch.float32, device=x.device)
    _bwd_call("ssd_bwd_dbdc", x.data_ptr(), dy.data_ptr(), b.data_ptr(), c.data_ptr(),
              a_cum.data_ptr(), dcbT.data_ptr(), prev3.data_ptr(), dst3.data_ptr(),
              db.data_ptr(), dc.data_ptr(), d_state.data_ptr(), B, S, H, P, G, N, chunk, like=x)
    return db, dc, d_state


def bwd_da_kernel(d_intra: torch.Tensor, d_state: torch.Tensor, d_last: torch.Tensor,
                  P: int, N: int, chunk: int) -> torch.Tensor:
    """``ssd_bwd_da`` from the three kernels' slots: da (B, S, H) float32."""
    B, H, nc = d_state.shape[:3]
    da = torch.empty((B, nc * chunk, H), dtype=torch.float32, device=d_state.device)
    _bwd_call("ssd_bwd_da", d_intra.data_ptr(), d_state.data_ptr(), d_last.data_ptr(),
              da.data_ptr(), B, nc * chunk, H, P, N, chunk, like=d_state)
    return da


def _check(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           chunk: int, what: str = "ssd_scan") -> None:
    """Raise on inputs the kernels do not take."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    refuse_dtensor(what, x, a_log, b, c)
    if not x.is_cuda and _shape.data_free(x):
        return
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
    if _shape.data_free(x):
        y = torch.empty_like(x)
        state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        _shape.OPS["ssd_scan"](x, a_log, b, c, y, state, chunk)
        return y, state
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
    if not x.is_cuda and not _shape.data_free(x):
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
    kernels (one count a call), CPU tensors take ``ssd_scan_bwd_ref``.
    bfloat16 runs the six stages on the tensor cores and is bit-reproducible
    (db and dc summed over a group's heads in a fixed order); float32 runs
    the CUDA-core kernels, which add db and dc with f32 atomics in an order
    that changes from run to run: not bit-reproducible."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    chunk = min(chunk, S)
    free = _shape.data_free(x)
    if not x.is_cuda and not free:
        return ssd_scan_bwd_ref(x, a_log, b, c, dy, dstate, chunk)
    _check(x, a_log, b, c, chunk, "ssd_scan_bwd")
    if dy.shape != x.shape or dy.device != x.device or (
            dstate is not None and (tuple(dstate.shape) != (B, H, P, N)
                                    or dstate.device != x.device)):
        raise ValueError(f"ssd_scan_bwd: dy{tuple(dy.shape)} / dstate "
                         f"{None if dstate is None else tuple(dstate.shape)} do not match "
                         f"x{tuple(x.shape)}, state ({B}, {H}, {P}, {N})")
    x, a_log, b, c = (t.detach().contiguous() for t in (x, a_log, b, c))
    dy = dy.to(x.dtype).contiguous()
    dstate = None if dstate is None else dstate.to(torch.float32).contiguous()
    if free:
        dx, da = torch.empty_like(x), torch.empty((B, S, H), dtype=torch.float32,
                                                  device=x.device)
        db, dc = torch.empty_like(b), torch.empty_like(c)
        _shape.OPS["ssd_scan_bwd"](x, a_log, b, c, dy, dstate, dx, da, db, dc, chunk)
        return dx, da, db, dc
    if any(t.data_ptr() % 16 for t in (x, b, c, dy) + (() if dstate is None else (dstate,))):
        raise ValueError("ssd_scan_bwd: x, b, c, dy and dstate must be 16-byte aligned")
    if x.dtype == torch.bfloat16:
        states, d_prev, a_cum = bwd_chunk_state_kernel(x, a_log, b, c, dy, chunk)
        prev3, dst3, d_last = bwd_state_passing_kernel(states, d_prev, a_cum, dstate)
        del states, d_prev
        cbT, dcbT, d_intra = bwd_dcb_kernel(x, dy, b, c, a_cum)
        dx = bwd_dx_kernel(dy, b, a_cum, cbT, dst3)
        db, dc, d_state = bwd_dbdc_kernel(x, dy, b, c, a_cum, dcbT, prev3, dst3)
        da = bwd_da_kernel(d_intra, d_state, d_last, P, N, chunk)
    else:
        nc, f32 = S // chunk, dict(dtype=torch.float32, device=x.device)
        # f32 scratch: a_cum, the chunk states (then their cotangents), the state
        # entering each chunk, dy's share of its cotangent, d(chunk decay)
        a_cum = torch.empty((B, H, nc, chunk), **f32)
        states, prev, d_prev = (torch.empty((B, nc, H, P, N), **f32) for _ in range(3))
        d_decay = torch.empty((B, H, nc), **f32)
        dx, da = torch.empty_like(x), torch.empty((B, S, H), **f32)
        db, dc = torch.empty_like(b), torch.empty_like(c)   # zeroed by the first kernel
        _bwd_call("ssd_scan_bwd_f32", x.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                  c.data_ptr(), dy.data_ptr(), 0 if dstate is None else dstate.data_ptr(),
                  a_cum.data_ptr(), states.data_ptr(), prev.data_ptr(), d_prev.data_ptr(),
                  d_decay.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(),
                  dc.data_ptr(), B, S, H, P, G, N, chunk, like=x)
    global bwd_launches
    bwd_launches += 1
    return dx, da, db, dc
