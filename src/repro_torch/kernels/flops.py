# A copy of src/repro/kernels/flops.py (the port imports nothing of the JAX package).
# Keep it verbatim: calibrated rates must count FLOPs as the reference does.
"""Analytic FLOP counts for the kernel hot-spots.

The calibration microbenchmarks (``repro.calibrate``) time the real
kernel entry points in ``ops.py`` and need a matching analytic count to
turn seconds into an achieved-FLOP/s rate (and from there into a
``ProfiledCosts`` compute factor).  Counts follow the usual 2-FLOPs-per
-MAC convention and only count the dominant contractions — softmax,
masking and elementwise gates are ignored, exactly as the planning
graph's ``graph_builders`` do, so kernel rates and graph rates are
comparable.
"""
from __future__ import annotations


def flash_attention_flops(B: int, S: int, H: int, KV: int, d: int) -> float:
    """Causal flash attention over (B, S, H, d) queries / (B, S, KV, d)
    keys+values: QK^T and PV score contractions (causal halves both)."""
    return 2.0 * 2.0 * B * H * S * S * d * 0.5


def decode_attention_flops(B: int, T: int, H: int, d: int) -> float:
    """One decode step against a T-long KV cache."""
    return 2.0 * 2.0 * B * H * T * d


def ssd_scan_flops(B: int, S: int, H: int, P: int, G: int, N: int) -> float:
    """Mamba-2 SSD chunked scan: per-token state update + output read
    (x·Bᵀ outer product into (P, N) state, C·state read-out)."""
    return 2.0 * 3.0 * B * S * H * P * N


def rglru_scan_flops(B: int, S: int, W: int) -> float:
    """RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t (one MAC per
    element per step)."""
    return 2.0 * B * S * W


def mlp_block_flops(batch: int, d_model: int, d_ff: int,
                    gated: bool = True) -> float:
    """Gated (3-matmul) or plain (2-matmul) MLP block forward."""
    mats = 3 if gated else 2
    return 2.0 * mats * batch * d_model * d_ff
