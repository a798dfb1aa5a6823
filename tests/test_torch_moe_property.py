"""MoE grouped-dispatch invariants on the port (repro_torch.models.mlp): the
jax-free mirror of ``tests/test_moe_property.py``, against the same numpy
dense mixture. It imports neither jax nor the JAX package."""
import dataclasses

import numpy as np
import torch
from helpers._hypothesis_compat import given, settings, st

from repro_torch.configs import reduced_config
from repro_torch.models.mlp import apply_moe, dispatch_groups, init_moe, moe_capacity

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)


def _cfg(E=4, K=2, d=16, f=32, cap=8.0, groups=0):
    base = reduced_config("olmoe_1b_7b")
    return dataclasses.replace(base, n_experts=E, experts_per_token=K,
                               d_model=d, moe_d_ff=f, capacity_factor=cap,
                               router_aux_coef=0.0, moe_groups=groups)


def _init(seed, cfg):
    return init_moe(torch.Generator().manual_seed(seed), cfg, torch.float32)


def _normal(seed, shape, scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale


def _dense_reference(p, x, cfg):
    """Naive per-token top-k mixture over ALL experts (no capacity)."""
    B, S, D = x.shape
    xf = x.reshape(-1, D).double().numpy()
    router = p["router"].double().numpy()
    logits = xf @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        top = np.argsort(-probs[t])[: cfg.experts_per_token]
        g = probs[t, top]
        g = g / g.sum()
        for e, w in zip(top, g):
            up = xf[t] @ p["w_up"][e].double().numpy()
            gt = xf[t] @ p["w_gate"][e].double().numpy()
            silu = gt / (1.0 + np.exp(-gt)) * up
            out[t] += w * (silu @ p["w_down"][e].double().numpy())
    return out.reshape(B, S, D)


@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([1, 2, 4]),
       st.sampled_from([4, 8]))
@settings(max_examples=10, deadline=None)
def test_lossless_capacity_matches_dense_mixture(seed, B, S):
    cfg = _cfg()
    p = _init(seed, cfg)
    x = _normal(seed + 1, (B, S, cfg.d_model), 0.5)
    out, aux = apply_moe(p, x, cfg)
    ref = _dense_reference(p, x, cfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-3)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_group_count_invariance(seed):
    """With lossless capacity, routing is per-token → the group count
    must not change the result."""
    outs = []
    for groups in (1, 2, 4):
        cfg = _cfg(groups=groups)
        p = _init(0, cfg)
        x = _normal(seed, (2, 8, cfg.d_model), 0.5)
        out, _ = apply_moe(p, x, cfg)
        outs.append(out.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-5, rtol=1e-5)


def test_capacity_drops_tokens():
    """Tiny capacity must produce a different (partially-zero) output and
    never NaN."""
    cfg = _cfg(cap=0.05, groups=1)      # capacity 2/expert for 64 tokens
    p = _init(0, cfg)
    x = _normal(1, (2, 32, cfg.d_model))
    out, aux = apply_moe(p, x, cfg)
    assert bool(torch.all(torch.isfinite(out)))
    full = _cfg(cap=float(cfg.n_experts))
    out_full, _ = apply_moe(p, x, full)
    assert float(torch.max(torch.abs(out - out_full))) > 1e-3


def test_dispatch_groups_divides():
    cfg = _cfg()
    for t in (32, 48, 64, 1024, 7):
        g = dispatch_groups(t, cfg)
        assert t % g == 0
        assert t // g >= cfg.experts_per_token or g == 1


def test_capacity_formula():
    cfg = _cfg(E=8, K=2, cap=1.25)
    assert moe_capacity(cfg, 64) == int(1.25 * 64 * 2 / 8) + 1
