"""RG-LRU linear recurrence h_t = exp(a_log_t) h_{t-1} + b_t: CUDA kernel
wrappers, launch counters, plain PyTorch versions and the gradient.

Replaces the Pallas TPU kernel ``_rglru_kernel`` in
``src/repro/kernels/rglru_scan.py``; the kernel itself is
``csrc/rglru_scan.cu``, whose header says what bounds it on an H100 and
what its design does about that.

``rglru_scan`` launches the kernel for CUDA tensors (or raises) and takes
``rglru_scan_ref`` for CPU tensors, through which autograd then
differentiates. On the card, when grad is needed, it goes through
``RglruScanFn``, whose backward is ``rglru_scan_bwd``: the kernel
``rglru_bwd_kernel`` of the same source (the JAX package has no Pallas
backward; it differentiates its associative-scan oracle). Its plain version
is ``rglru_scan_bwd_ref``. ``launches`` counts forward launches,
``bwd_launches`` backward launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from ._guard import refuse_dtensor

launches = 0
bwd_launches = 0


def rglru_scan_ref(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a_log, b (B,S,W) -> (h (B,S,W) f32, h_last (B,W) f32),
    from a zero state, as a Hillis–Steele doubling scan over the sequence
    axis (⌈log2 S⌉ rounds of whole-tensor products, the TPU kernel's
    algorithm; PyTorch has no public associative scan)."""
    a = torch.exp(a_log.float())
    h = b.float()
    k, S = 1, h.shape[1]
    while k < S:
        h = torch.cat([h[:, :k], h[:, k:] + a[:, k:] * h[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return h, h[:, -1]


def rglru_scan_bwd_ref(a_log: torch.Tensor, h: torch.Tensor, dh: Optional[torch.Tensor],
                       dh_last: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward: (da_log, db) (B,S,W) float32 from a_log,
    the forward's h, and the cotangents dh (B,S,W) and dh_last (B,W), either
    None for zero. With a_t = exp(a_log_t) and h_{-1} = 0:
    g_{S-1} = dh_{S-1} + dh_last, g_t = dh_t + a_{t+1} g_{t+1}; db = g and
    da_log_t = g_t a_t h_{t-1}. g is ``rglru_scan_ref``'s doubling scan run
    over the reversed sequence, with coefficient a_{t+1} at step t."""
    g_in = torch.zeros_like(h, dtype=torch.float32) if dh is None else dh.float()
    if dh_last is not None:
        g_in = torch.cat([g_in[:, :-1], g_in[:, -1:] + dh_last.float()[:, None]], dim=1)
    a_next = torch.cat([torch.zeros_like(a_log[:, :1]), a_log[:, 1:].flip(1)], dim=1)
    g = rglru_scan_ref(a_next, g_in.flip(1))[0].flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1).float()
    return g * torch.exp(a_log.float()) * h_prev, g


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("rglru_scan"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s entry points typed: a build of ``csrc/rglru_scan.cu`` (or of
    an edited copy, as ``tools/rglru_variants.py`` loads)."""
    lib.rglru_scan_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rglru_scan_bwd.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(what: str, a_log: torch.Tensor, x: torch.Tensor) -> None:
    """a_log and x (b for the forward, h for the backward): float32 (B,S,W)
    with S > 0 on one CUDA device."""
    refuse_dtensor(what, a_log, x)
    if not (x.is_cuda and x.device == a_log.device):
        raise ValueError(f"{what}: a_log and its second input must lie on one CUDA device")
    if a_log.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"{what}: dtype {a_log.dtype}, {x.dtype} not supported (float32)")
    if a_log.ndim != 3 or a_log.shape != x.shape or a_log.shape[1] == 0:
        raise ValueError(f"{what}: shapes {tuple(a_log.shape)}, {tuple(x.shape)} not "
                         "supported (equal, (B,S,W), S > 0)")


def _forward(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel (inputs checked and contiguous)."""
    B, S, W = a_log.shape
    h = torch.empty_like(b)
    h_last = torch.empty((B, W), dtype=torch.float32, device=b.device)
    lib = _lib()
    err = lib.rglru_scan_fwd(a_log.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(),
                             B, S, W, torch.cuda.current_stream(b.device).cuda_stream)
    if err:
        raise RuntimeError("rglru_scan kernel: " + lib.rglru_scan_error_string(err).decode())
    global launches
    launches += 1
    return h, h_last


class RglruScanFn(torch.autograd.Function):
    """The card's RG-LRU scan with its gradient: the forward kernel with
    a_log and h saved, ``rglru_scan_bwd`` for (da_log, db). A cotangent that
    autograd leaves out (h_last's when only h is used, as in training) is
    read as zero."""

    @staticmethod
    def forward(ctx, a_log, b):
        ctx.set_materialize_grads(False)
        h, h_last = _forward(a_log, b)
        ctx.save_for_backward(a_log, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        if dh is None and dh_last is None:
            return None, None
        a_log, h = ctx.saved_tensors
        return rglru_scan_bwd(a_log, h, dh, dh_last)


def rglru_scan(a_log: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_log, b (B,S,W) float32 -> (h (B,S,W) float32, h_last (B,W) float32).
    Differentiable: on the card through ``RglruScanFn`` when grad is needed."""
    if not a_log.is_cuda:
        return rglru_scan_ref(a_log, b)
    _check("rglru_scan", a_log, b)
    a_log, b = a_log.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (a_log.requires_grad or b.requires_grad):
        return RglruScanFn.apply(a_log, b)
    return _forward(a_log, b)


def rglru_scan_bwd(a_log: torch.Tensor, h: torch.Tensor, dh: Optional[torch.Tensor],
                   dh_last: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da_log, db) (B,S,W) float32 of ``rglru_scan`` from a_log, its output
    h and the cotangents dh (B,S,W) and dh_last (B,W) (None for zero). CUDA
    tensors launch the backward kernel (one count a call), CPU tensors take
    ``rglru_scan_bwd_ref``."""
    if not a_log.is_cuda:
        return rglru_scan_bwd_ref(a_log, h, dh, dh_last)
    _check("rglru_scan_bwd", a_log, h)
    B, S, W = a_log.shape
    for name, t, shape in (("dh", dh, (B, S, W)), ("dh_last", dh_last, (B, W))):
        if t is not None and (tuple(t.shape) != shape or t.device != a_log.device):
            raise ValueError(f"rglru_scan_bwd: {name}{tuple(t.shape)} on {t.device} does not "
                             f"match {shape} on {a_log.device}")
    a_log, h = a_log.detach().contiguous(), h.detach().contiguous()
    dh = None if dh is None else dh.detach().to(torch.float32).contiguous()
    dh_last = None if dh_last is None else dh_last.detach().to(torch.float32).contiguous()
    da_log, db = torch.empty_like(a_log), torch.empty_like(a_log)
    lib = _lib()
    err = lib.rglru_scan_bwd(a_log.data_ptr(), h.data_ptr(), None if dh is None else dh.data_ptr(),
                             None if dh_last is None else dh_last.data_ptr(), da_log.data_ptr(),
                             db.data_ptr(), B, S, W,
                             torch.cuda.current_stream(a_log.device).cuda_stream)
    if err:
        raise RuntimeError("rglru_scan_bwd kernel: "
                           + lib.rglru_scan_error_string(err).decode())
    global bwd_launches
    bwd_launches += 1
    return da_log, db
