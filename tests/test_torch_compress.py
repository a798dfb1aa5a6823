"""int8 + error-feedback gradient compression (``repro_torch.optim.compress``)
against the JAX package's (``repro.optim.compress``).

The first three tests mirror ``tests/test_compress.py`` on the port. Then
parity on the same inputs (seeded numpy, in both packages): the int8 codes
and scales are equal (float32 and bfloat16 inputs, the scale a float32
division, ``round`` half to even in both), ``ef_compress`` over a nested tree
for three steps gives the same outputs and residuals within 1e-6 (the norm
sums the leaves in another order); and on two gloo ranks a DTensor leaf's
scale is its whole tensor's absmax, not its shard's.
"""
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import dequantize_int8 as jdequantize_int8, ef_compress as jef_compress
from repro.optim import ef_init as jef_init, quantize_int8 as jquantize_int8
from repro_torch.models.sharding_utils import P
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, dequantize_int8,
                               ef_compress, ef_init, quantize_int8)
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402  (the ranks' functions, importable by spawned processes)

torch.set_num_threads(2)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32)) * 3.0
    q, s = quantize_int8(x)
    err = torch.max(torch.abs(dequantize_int8(q, s) - x))
    assert float(err) <= float(s) / 2 + 1e-6        # half-ulp bound
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0


def test_error_feedback_is_unbiased_over_time():
    """Sum of decompressed = sum of true grads up to the final residual (EF)."""
    g_true = [torch.from_numpy(np.random.default_rng(i).standard_normal(64).astype(np.float32))
              for i in range(20)]
    ef = ef_init({"w": g_true[0]})
    acc_deq = torch.zeros(64)
    for g in g_true:
        deq, ef, _ = ef_compress({"w": g}, ef)
        acc_deq = acc_deq + deq["w"]
    np.testing.assert_allclose((acc_deq + ef["w"]).numpy(), sum(g_true).numpy(), atol=1e-4,
                               rtol=1e-4)


def test_compressed_training_still_converges():
    params = {"x": torch.tensor([4.0, -2.0, 1.0])}
    opt = adamw_init(params)
    ef = ef_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    for _ in range(300):
        g = {"x": 2.0 * params["x"]}               # the gradient of sum(x ** 2)
        g, ef, _ = ef_compress(g, ef)
        params, opt, _ = adamw_update(g, opt, params, 0.05, cfg)
    assert float(torch.sum(params["x"] ** 2)) < 1e-3


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages: float32 numpy rounded to ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a.astype(ml_dtypes.bfloat16)),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((256,), 3.0), ((4, 33, 17), 1e-3), ((8, 64), 250.0)])
def test_quantize_int8_matches_jax(dtype, shape, scale):
    a = (np.random.default_rng(len(shape)).standard_normal(shape) * scale).astype(np.float32)
    a.flat[7] = 0.5 * float(np.abs(a).max())        # ties: x / scale lands on k + 0.5
    j, t = _pair(a, dtype)
    jq, js = jquantize_int8(j)
    tq, ts = quantize_int8(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jdequantize_int8(jq, js)))


def test_round_is_half_to_even():
    """x / scale = k + 0.5 rounds to the even k in both packages."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, s = quantize_int8(x)
    assert float(s) == pytest.approx(1.0)
    jq, _ = jquantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist()[1:] == [0, 2, 2, 0, -2]


def _tree(rng):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "stack": {"u0": {"w": (rng.standard_normal((2, 8, 8)) * 1e-2).astype(np.float32),
                             "ln": rng.standard_normal((2, 8)).astype(np.float32)}},
            "bias": (rng.standard_normal(5) * 40.0).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_matches_jax_over_three_steps(dtype):
    rng = np.random.default_rng(5)
    jef, tef = jef_init(jax.tree.map(jnp.asarray, _tree(rng))), None
    for step in range(3):
        g = _tree(rng)
        jg = jax.tree.map(lambda a: _pair(a, dtype)[0], g)
        tg = jax.tree.map(lambda a: _pair(a, dtype)[1], g)
        tef = ef_init(tg) if tef is None else tef
        jout, jef, jm = jef_compress(jg, jef)
        tout, tef, tm = ef_compress(tg, tef)
        for key, want in _flat(jax.tree.map(np.asarray, jout)).items():
            np.testing.assert_allclose(_flat(tout)[key], want, rtol=0, atol=1e-6,
                                       err_msg=f"{step} {key}")
        for key, want in _flat(jax.tree.map(np.asarray, jef)).items():
            np.testing.assert_allclose(_flat(tef)[key], want, rtol=0, atol=1e-6,
                                       err_msg=f"{step} {key}")
        assert all(t.dtype == getattr(torch, dtype) for t in jax.tree.leaves(
            tout, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert tm["ef_residual_norm"].ndim == 0
        assert float(tm["ef_residual_norm"]) == pytest.approx(float(jm["ef_residual_norm"]),
                                                              rel=1e-6)


def test_dtensor_leaf_scale_is_global_on_two_gloo_ranks():
    """A leaf sharded over two ranks, its absmax on rank 1's half, a
    replicated leaf and a leaf of pending partial sums (each rank a share,
    as a gradient may arrive): the scale, codes, outputs, residuals and norm
    equal the plain call's on the whole tensors."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    w[6, 2] = 30.0                                  # rank 1's half holds the absmax
    b = rng.standard_normal(6).astype(np.float32)
    # a third of it on rank 0, two on rank 1: these values' shares sum back exactly
    c = np.array([0.5, -1.5, 2.5, 4.0], np.float32)
    tree = {"w": (torch.from_numpy(w), P("model", None)), "b": (torch.from_numpy(b), P()),
            "c": (torch.from_numpy(c), "partial")}
    got = run_ranks(torch_mesh_ranks.compress_rank, 2, (tree, 3), backend="gloo", timeout=300)
    plain = {k: t for k, (t, _) in tree.items()}
    ef = ef_init(plain)
    want_deq, want_res, want_norm = [], [], []
    for _ in range(3):
        deq, ef, m = ef_compress(plain, ef)
        want_deq.append(deq)
        want_res.append(ef)
        want_norm.append(m["ef_residual_norm"])
    for r in got:
        assert r["laid_out"]
        for k, t in plain.items():
            q, s = quantize_int8(t)
            assert float(r["scales"][k]) == float(s)
            assert torch.equal(r["codes"][k], q)
        assert float(r["scales"]["w"]) == pytest.approx(30.0 / 127.0)
        for i in range(3):
            for k in plain:
                assert torch.equal(r["deq"][i][k], want_deq[i][k])
                assert torch.equal(r["res"][i][k], want_res[i][k])
            assert float(r["norms"][i]) == pytest.approx(float(want_norm[i]), rel=1e-6)
