"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the Pallas TPU kernel in interpret mode (or its
pure-jnp oracle, ``repro.kernels.ref``), at the shapes of
tests/test_kernels.py. Inputs come from a numpy seed and reach both
packages as the same numbers. Tolerances are the JAX package's own:
float32 atol/rtol 2e-5, bfloat16 2e-2 (the Pallas kernel keeps the softmax
weights in f32, the plain version casts them to q's type before PV).

tests/test_torch_gpu.py holds each CUDA kernel against its plain version on
the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode_pallas
from repro.kernels.flash_attention import flash_attention as jflash_pallas
from repro.kernels.rglru_scan import rglru_scan as jrglru_pallas
from repro.kernels.ssd_scan import ssd_scan as jssd_pallas
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.decode_attention import (SPLIT_TILE, decode_attention_splits_ref,
                                                  split_plan)

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- flash
@pytest.mark.parametrize("B,S,H,KV,d", [
    (2, 256, 4, 2, 64),
    (1, 384, 8, 8, 128),      # S % block != 0
    (2, 128, 4, 1, 64),       # MQA
    (1, 512, 16, 4, 32),
    (1, 256, 8, 2, 80),       # h2o-danube-1.8b's head_dim
    (2, 256, 8, 2, 16),       # the reduced dense configs' head_dim
    (2, 256, 4, 4, 24),       # the reduced whisper_small's
    (2, 256, 4, 1, 32),       # the reduced recurrentgemma_9b's and paligemma_3b's (MQA)
])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(B, S, H, KV, d, window, dtype):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, S, n, d), dtype) for n in (H, KV, KV))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    if dtype == "float32" and S <= 256:
        exp = jflash_pallas(jq, jk, jv, causal=True, window=window, interpret=True)
    else:                     # interpret mode is slow at these sizes: the oracle
        exp = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, d)
    np.testing.assert_allclose(_np(out), _np(exp), **_tol(dtype))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_plain_ragged_t(causal):
    """S != T (128 queries, 256 keys), against the Pallas kernel."""
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, n, 4, 64), "float32")
                                    for n in (128, 256, 256))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    exp = jflash_pallas(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- flash backward
@pytest.mark.parametrize("B,S,H,KV,d,window", [
    (2, 96, 4, 4, 64, None),      # G = 1
    (1, 128, 8, 2, 32, None),     # G = 4
    (1, 100, 8, 1, 64, 24),       # G = 8, ragged S, window
    (2, 64, 4, 1, 16, 16),        # G = 4, window
    (2, 96, 4, 4, 24, None),      # the reduced whisper_small: head_dim 24, G = 1
    (1, 100, 4, 1, 24, 40),       # head_dim 24, ragged S, window
    (1, 70, 4, 1, 32, 32),        # the reduced recurrentgemma_9b: MQA, its window of 32
])
def test_flash_attention_bwd_plain_matches_jax_vjp(B, S, H, KV, d, window):
    """flash_attention_bwd_ref (FlashAttention-2's formulas, no autograd)
    against jax.vjp of the JAX package's reference, and the plain
    log-sum-exp against jax.nn.logsumexp of its masked scores."""
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, (B, S, n, d), "float32") for n in (H, KV, KV, H))
    jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=True,
                                                                 window=window), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=True, window=window)
    dq, dk, dv = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True,
                                             window=window)
    for got, exp in ((out, jout), (dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(exp), atol=2e-5, rtol=2e-5)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    live = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    scores = jnp.einsum("bshd,bthd->bhst", jq, jnp.repeat(jk, H // KV, axis=2)) * d ** -0.5
    jlse = jax.nn.logsumexp(jnp.where(live, scores, -jnp.inf), axis=-1)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,KV,window", [
    (1, 160, 8, 2, None),
    (2, 100, 4, 1, 48),           # ragged S, MQA, window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_plain_matches_jax_vjp_head_dim_80(B, S, H, KV, window, dtype):
    """The plain backward at h2o-danube-1.8b's head_dim 80 against jax.vjp
    of the JAX package's reference. bfloat16: the plain version takes the
    bf16 values (its forward rounds the weights to bf16, its gradients come
    out in bf16) and JAX differentiates the same values in float32, within
    the bfloat16 tolerance."""
    d = 80
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, (B, S, n, d), dtype) for n in (H, KV, KV, H))
    jq, jk, jv, jdo = (x.astype(jnp.float32) for x in (jq, jk, jv, jdo))
    jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=True,
                                                                 window=window), jq, jk, jv)
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=True, window=window)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True, window=window)
    for got, exp in zip((out,) + grads, (jout,) + vjp(jdo)):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.parametrize("B,S,window", [
    (1, 96, 24),                  # the window binds from row 24 on
    (2, 70, 40),                  # ragged S
])
def test_flash_attention_bwd_plain_matches_jax_vjp_head_dim_256(B, S, window):
    """The plain backward at recurrentgemma-9b's attention layout (head_dim
    256, 16 query heads on one KV head, a window that binds) against
    jax.vjp of the JAX package's reference, in float32 at 2e-5."""
    H, KV, d = 16, 1, 256
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, (B, S, n, d), "float32") for n in (H, KV, KV, H))
    jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=True,
                                                                 window=window), jq, jk, jv)
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=True, window=window)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True, window=window)
    for got, exp in zip((out,) + grads, (jout,) + vjp(jdo)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 20])
def test_flash_attention_autograd_on_cpu_equals_plain_bwd(window):
    """On CPU tensors autograd differentiates the plain forward; it agrees
    with the plain backward the card's kernel is held to, and launches
    nothing."""
    rng = np.random.default_rng(6)
    B, S, H, KV, d = 2, 72, 8, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, d)).astype(np.float32))
               .requires_grad_(True) for n in (H, KV, KV))
    dout = torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(np.float32))
    before = kernels.launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert kernels.launch_counts() == before
    with torch.no_grad():
        lse = ref.flash_attention_lse_ref(q, k, causal=True, window=window)
        exp = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
    for got, want in zip(grads, exp):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _split_heads(G: int, n: int, sp: int) -> range:
    """The query heads (within a group) that split ``sp`` of ``n`` takes."""
    return range(sp * G // n, (sp + 1) * G // n)


@pytest.mark.parametrize("B,S,KV,G", [
    (2, 4096, 8, 8),      # qwen3-32b training
    (2, 8192, 8, 4),      # h2o-danube-1.8b training
    (1, 4096, 1, 48),     # granite-20b's group
    (1, 100, 1, 8),       # one block
    (1, 1000, 2, 6),
    (3, 64, 1, 7),        # G prime
])
def test_bwd_split_plan_covers_every_query_head_once(B, S, KV, G):
    n = kernels.flash_attention.bwd_split_plan(B, S, KV, G)
    assert 1 <= n <= G
    seen = np.zeros(G, np.int64)
    for sp in range(n):
        seen[list(_split_heads(G, n, sp))] += 1
    assert (seen == 1).all()
    for m in range(1, G + 1):          # the kernel's head ranges at any split count
        assert sorted(g for sp in range(m) for g in _split_heads(G, m, sp)) == list(range(G))


def test_bwd_split_plan_at_the_training_and_granite_shapes():
    """No split where the key tiles alone fill the H100's 132 SMs (qwen3's
    512 blocks, h2o's 1024); granite-20b's 48-head group at B = 1, S = 4096
    (32 key tiles) split into a divisor of 48 giving at least 132 blocks."""
    plan, tile = kernels.flash_attention.bwd_split_plan, kernels.flash_attention.BWD_KEY_TILE
    assert plan(2, 4096, 8, 8) == 1 and 4096 // tile * 8 * 2 == 512
    assert plan(2, 8192, 8, 4) == 1 and 8192 // tile * 8 * 2 == 1024
    n = plan(1, 4096, 1, 48)
    assert 48 % n == 0 and 4096 // tile * n >= 132
    assert plan(1, 100, 1, 8) == 8      # one key tile: every head its own block


def test_bwd_split_plan_at_recurrentgemma_training_shape():
    """head_dim 256 takes 64-key tiles: recurrentgemma-9b's B = 2, S = 4096
    on one KV head is 128 blocks, under 132, so its 16-head group is split
    in two (256 blocks); the other head dims keep 128-key tiles."""
    fa = kernels.flash_attention
    assert fa.bwd_key_tile(256) == 64 and fa.bwd_key_tile(128) == fa.bwd_key_tile(80) == 128
    assert fa.bwd_split_plan(2, 4096, 1, 16, 256) == 2
    assert fa.bwd_split_plan(2, 4096, 1, 16) == 4          # at 128-key tiles: 64 blocks
    assert fa.bwd_split_plan(2, 8192, 1, 16, 256) == 1     # 256 blocks fill the card


@pytest.mark.parametrize("B,S,H,KV,d,window", [
    (1, 100, 8, 1, 32, None),      # one block: the plan splits the group 8 ways
    (1, 130, 12, 2, 16, 40),       # two key tiles, G = 6, window
])
def test_flash_attention_bwd_split_sums_match_plain_and_jax_vjp(B, S, H, KV, d, window):
    """dk and dv summed over the split plan's head ranges (the plain backward
    on each range's heads alone, added in float32, as the kernel's split
    accumulators add them) and dq taken per range, against the one-pass
    plain backward and jax.vjp of the JAX package's reference, at 2e-5."""
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, (B, S, n, d), "float32") for n in (H, KV, KV, H))
    G = H // KV
    n = kernels.flash_attention.bwd_split_plan(B, S, KV, G)
    assert n > 1
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=True, window=window)
    dq, dk, dv = torch.zeros_like(tq), torch.zeros_like(tk), torch.zeros_like(tv)
    for sp in range(n):
        heads = [j * G + g for j in range(KV) for g in _split_heads(G, n, sp)]
        gq, gk, gv = ref.flash_attention_bwd_ref(tq[:, :, heads], tk, tv, out[:, :, heads],
                                                 lse[:, heads], tdo[:, :, heads], causal=True,
                                                 window=window, scale=d ** -0.5)
        dq[:, :, heads] = gq
        dk += gk
        dv += gv
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True, window=window)
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=True,
                                                              window=window), jq, jk, jv)
    for got, p, j in zip((dq, dk, dv), plain, vjp(jdo)):
        np.testing.assert_allclose(_np(got), _np(p), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_np(got), _np(j), atol=2e-5, rtol=2e-5)


def test_flash_attention_lse_ref_row_without_live_key_is_inf():
    q = torch.randn(1, 4, 2, 16)
    k = torch.randn(1, 6, 2, 16)
    lse = ref.flash_attention_lse_ref(q, k, causal=True, window=None)
    assert torch.isfinite(lse).all()
    # causally row s sees keys 0..s (T > S here); a window of 0 sees no key
    assert torch.isinf(ref.flash_attention_lse_ref(q, k, causal=True, window=0)).all()


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("B,T,H,KV,d", [
    (2, 512, 4, 2, 64),
    (3, 300, 8, 1, 128),      # T % block != 0
    (2, 512, 4, 4, 64),
    (2, 300, 16, 1, 256),     # recurrentgemma's MQA head_dim
    (2, 300, 8, 2, 80),       # h2o-danube-1.8b's head_dim
    (2, 64, 8, 2, 16),        # the reduced dense configs' head_dim (calibration's decode step)
    (2, 64, 4, 4, 24),        # the reduced whisper_small's (G = 1)
    (3, 300, 4, 1, 32),       # the reduced recurrentgemma_9b's and paligemma_3b's (MQA)
])
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_jax(B, T, H, KV, d, window, dtype):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (B, 1, H, d), dtype)
    jk, tk = _pair(rng, (B, T, KV, d), dtype)
    jv, tv = _pair(rng, (B, T, KV, d), dtype)
    lens = np.full((B,), T // 3 + 1, np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), window=window)
    if dtype == "float32":
        exp = jdecode_pallas(jq, jk, jv, jnp.asarray(lens), window=window, interpret=True)
    else:
        exp = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens), window=window)
    assert out.dtype == tq.dtype and out.shape == (B, 1, H, d)
    np.testing.assert_allclose(_np(out), _np(exp), **_tol(dtype))


def test_decode_attention_plain_per_batch_lengths():
    rng = np.random.default_rng(3)
    B, T, H, d = 4, 256, 4, 64
    jq, tq = _pair(rng, (B, 1, H, d), "float32")
    jk, tk = _pair(rng, (B, T, H, d), "float32")
    jv, tv = _pair(rng, (B, T, H, d), "float32")
    lens = np.array([1, 17, 100, 256], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    exp = jdecode_pallas(jq, jk, jv, jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- decode: split-KV
@pytest.mark.parametrize("T,B,KV,G", [
    (4128, 4, 8, 8),      # qwen3-32b decode, batch 4
    (2048, 4, 1, 16),     # recurrentgemma-9b local attention, batch 4
    (300, 3, 1, 8),
    (32, 3, 1, 8),        # one split
    (1, 1, 1, 1),
    (65536, 1, 1, 8),
    (4128, 64, 8, 8),     # enough blocks without splitting much
])
def test_split_plan_covers_every_key_once(T, B, KV, G):
    split_len, n_splits = split_plan(T, B, KV, G)
    assert split_len >= SPLIT_TILE and split_len % SPLIT_TILE == 0   # whole tiles, at least one
    covered = np.zeros(T, np.int64)
    for s in range(n_splits):
        assert s * split_len < T                                       # no split past the cache
        covered[s * split_len:min((s + 1) * split_len, T)] += 1
    assert (covered == 1).all()


def test_split_plan_fills_the_card_at_the_serving_shapes():
    """qwen3-32b (B=4, T=4128, KV=8, G=8, one 16-head block a KV head):
    at least two blocks on each of the H100's 132 SMs; recurrentgemma-9b
    (B=4, T=2048, KV=1, G=16): at least one, where one-tile splits cap it."""
    split_len, n = split_plan(4128, 4, 8, 8)
    assert 4 * 8 * n >= 264
    split_len, n = split_plan(2048, 4, 1, 16)
    assert 4 * 1 * n >= 132 and (split_len, n) == (SPLIT_TILE, 2048 // SPLIT_TILE)


# (B, T, H, KV, d), cache_len, window: the serving shapes with few heads; the
# lengths leave whole splits empty (1 and 0), and 0 gives a row of zeros
SPLIT_CASES = {
    "qwen3": ((4, 4128, 8, 1, 64), [4128, 1, 0, 4127], None),
    "qwen3 window": ((4, 4128, 8, 1, 64), [4128, 3001, 1, 0], 1000),
    "recurrentgemma": ((4, 2048, 16, 1, 64), [2048, 1793, 256, 1], None),
    "recurrentgemma window": ((3, 2048, 16, 1, 32), [2048, 0, 700], 512),
    "h2o head_dim 80": ((2, 4128, 8, 2, 80), [4128, 1], None),
    "h2o head_dim 80 window": ((3, 1000, 8, 2, 80), [1000, 999, 0], 500),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_combine_matches_plain_and_jax(case, dtype):
    """The split-KV algorithm (per-split (m, l, acc), log-sum-exp combine)
    at several split counts against the one-pass plain version and the JAX
    package (the Pallas kernel in interpret mode for float32, its oracle
    for bfloat16), within their tolerances."""
    (B, T, H, KV, d), lens, window = SPLIT_CASES[case]
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng, (B, 1, H, d), dtype)
    jk, tk = _pair(rng, (B, T, KV, d), dtype)
    jv, tv = _pair(rng, (B, T, KV, d), dtype)
    cl = np.array(lens, np.int32)
    empty = cl == 0                 # no live key: the kernels write 0, a softmax would not
    exp_t = _np(ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(cl), window=window))
    if dtype == "float32":
        # key tiles that divide T (the Pallas kernel reads a ragged tail as padding)
        bk = max(n for n in range(1, 1025) if T % n == 0)
        exp_j = np.array(_np(jdecode_pallas(jq, jk, jv, jnp.asarray(cl), window=window,
                                            block_k=bk, interpret=True)))
        assert not exp_j[empty].any()
    else:
        exp_j = np.array(_np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(cl),
                                                       window=window)))
    exp_t[empty] = 0.0
    exp_j[empty] = 0.0
    plans = {split_plan(T, B, KV, H // KV), (SPLIT_TILE, -(-T // SPLIT_TILE)),
             (-(-T // SPLIT_TILE) * SPLIT_TILE, 1), (3 * SPLIT_TILE, -(-T // (3 * SPLIT_TILE)))}
    for split_len, n_splits in sorted(plans):
        out = decode_attention_splits_ref(tq, tk, tv, torch.from_numpy(cl), window=window,
                                          split_len=split_len, n_splits=n_splits)
        assert out.dtype == tq.dtype and out.shape == (B, 1, H, d)
        np.testing.assert_allclose(_np(out), exp_t, **_tol(dtype))
        np.testing.assert_allclose(_np(out), exp_j, **_tol(dtype))


# ---------------------------------------------------------------- ssd
def _ssd_inputs(rng, B, S, H, P, G, N, dtype, scale=0.1):
    """tests/test_kernels.py's distributions: x, b, c ~ N(0, scale²) in
    ``dtype``, a_log = -|N(0, 1)| * scale in float32."""
    x = _pair(rng, (B, S, H, P), "float32")[0] * scale
    a = -jnp.abs(_pair(rng, (B, S, H), "float32")[0]) * scale
    b = _pair(rng, (B, S, G, N), "float32")[0] * scale
    c = _pair(rng, (B, S, G, N), "float32")[0] * scale
    jd, td = DTYPES[dtype]
    jx, jb, jc = (t.astype(jd) for t in (x, b, c))
    tx, tb, tc = (torch.from_numpy(np.array(t, np.float32)).to(td) for t in (x, b, c))
    return (jx, a, jb, jc), (tx, torch.from_numpy(np.array(a)), tb, tc)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 512, 4, 64, 1, 128, 128),
    (1, 256, 8, 32, 2, 64, 64),
    (1, 128, 2, 64, 1, 32, 128),     # chunk > S → clamped
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas(B, S, H, P, G, N, chunk, dtype):
    jargs, targs = _ssd_inputs(np.random.default_rng(5), B, S, H, P, G, N, dtype)
    y, hf = ops.ssd_scan(*targs, chunk=chunk)
    ye, he = jssd_pallas(*jargs, chunk=min(chunk, S), interpret=True)
    assert y.dtype == targs[0].dtype and hf.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(ye), **_tol(dtype))
    np.testing.assert_allclose(_np(hf), _np(he), atol=1e-2 if dtype == "bfloat16" else 1e-4,
                               rtol=1e-2)


def test_ssd_scan_plain_matches_sequential_recurrence():
    """The chunked plain version equals the O(S) sequential SSM recurrence
    (tests/test_kernels.py's check of the Pallas kernel)."""
    B, S, H, P, N = 1, 64, 2, 8, 16
    _, (x, a, b, c) = _ssd_inputs(np.random.default_rng(6), B, S, H, P, 1, N, "float32",
                                  scale=0.2)
    y, hf = ops.ssd_scan(x, a, b, c, chunk=16)
    x, a, b, c = (t.double().numpy() for t in (x, a, b, c))
    h = np.zeros((B, H, P, N))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        h = np.exp(a[:, t])[:, :, None, None] * h + np.einsum("bhp,bn->bhpn", x[:, t],
                                                               b[:, t, 0])
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, c[:, t, 0])
    np.testing.assert_allclose(_np(y), ys, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(hf), h, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 256, 4, 32, 1, 64, 64),       # one group
    (1, 256, 8, 32, 2, 32, 64),       # two groups, H = 8
    (1, 300, 4, 32, 1, 32, 100),      # chunk 100 over S = 300
])
def test_ssd_stages_compose_to_jax_ssd_chunked_and_pallas(B, S, H, P, G, N, chunk):
    """The four plain stages (the card's bf16 path, stage by stage) composed
    by hand give the JAX package's ``ssd_chunked`` and the Pallas kernel in
    interpret mode, in float32 at 2e-5."""
    jargs, (x, a, b, c) = _ssd_inputs(np.random.default_rng(8), B, S, H, P, G, N, "float32")
    cb = tssd.ssd_cb(b, c, chunk)
    states, a_cum = tssd.ssd_chunk_state(x, a, b, chunk)
    prev, final = tssd.ssd_state_passing(states, a_cum)
    y = tssd.ssd_chunk_scan(x, a_cum, c, cb, prev)
    nc = S // chunk
    assert cb.shape == (B, nc, G, chunk, chunk) and states.shape == (B, nc, H, P, N)
    assert a_cum.shape == (B, H, nc, chunk) and prev.shape == states.shape
    for ye, he in (jax.jit(jssd_chunked, static_argnums=4)(*jargs, chunk),
                   jssd_pallas(*jargs, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(ye), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_np(final), _np(he), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_state_passing_matches_a_step_by_step_loop(with_h0):
    """``ssd_state_passing`` against h_{c+1} = exp(a_cum_c[-1]) h_c + states_c
    stepped chunk by chunk in float64: prev[c] is the state entering chunk c,
    the result the state after the last."""
    rng = np.random.default_rng(9)
    B, nc, H, P, N, L = 2, 5, 3, 16, 8, 7
    states = rng.standard_normal((B, nc, H, P, N)).astype(np.float32)
    a_cum = np.cumsum(-np.abs(rng.standard_normal((B, H, nc, L))) * 0.3, axis=-1,
                      dtype=np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    prev, final = tssd.ssd_state_passing(torch.from_numpy(states), torch.from_numpy(a_cum),
                                         None if h0 is None else torch.from_numpy(h0))
    h = np.zeros((B, H, P, N)) if h0 is None else h0.astype(np.float64)
    for ci in range(nc):
        np.testing.assert_allclose(_np(prev[:, ci]), h, atol=2e-5, rtol=2e-5)
        h = np.exp(a_cum[:, :, ci, -1].astype(np.float64))[..., None, None] * h + states[:, ci]
    np.testing.assert_allclose(_np(final), h, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- ssd backward
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 64, 8, 32, 1, 16, 32),       # the reduced mamba2 train step's shape (two chunks)
    (1, 256, 4, 64, 1, 64, 128),     # kernel_rates' shape
    (1, 192, 8, 32, 2, 32, 64),      # two groups, three chunks
    (1, 300, 4, 16, 4, 16, 100),     # a group per head, chunk 100
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_plain_matches_jax_vjp(B, S, H, P, G, N, chunk, dtype):
    """ssd_scan_bwd_ref (the stages' adjoints written out, no autograd)
    against jax.vjp of the JAX package's ``ssd_chunked``, with cotangents
    on y and on the final state. bfloat16: both take the same bf16 values,
    JAX differentiates them in float32; the plain version returns dx, db,
    dc in bf16, within the bfloat16 tolerance."""
    rng = np.random.default_rng(11)
    jargs, targs = _ssd_inputs(rng, B, S, H, P, G, N, dtype)
    jdy, tdy = _pair(rng, (B, S, H, P), dtype)
    jds, tds = _pair(rng, (B, H, P, N), "float32")
    jargs = tuple(t.astype(jnp.float32) for t in jargs)
    _, vjp = jax.vjp(lambda x, a, b, c: jssd_chunked(x, a, b, c, chunk), *jargs)
    want = vjp((jdy.astype(jnp.float32), jds))
    got = ref.ssd_scan_bwd_ref(*targs, tdy, tds, chunk)
    for g, w, t in zip(got, want, targs):
        assert g.dtype == t.dtype and g.shape == t.shape
        tol = _tol(dtype) if t.dtype == torch.bfloat16 else dict(atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def test_ssd_scan_bwd_without_a_state_cotangent():
    """``dstate=None`` reads as a zero cotangent of the final state."""
    rng = np.random.default_rng(12)
    jargs, targs = _ssd_inputs(rng, 1, 128, 4, 32, 1, 16, "float32")
    jdy, tdy = _pair(rng, (1, 128, 4, 32), "float32")
    _, vjp = jax.vjp(lambda x, a, b, c: jssd_chunked(x, a, b, c, 32), *jargs)
    want = vjp((jdy, jnp.zeros((1, 4, 32, 16), jnp.float32)))
    for g, w in zip(ref.ssd_scan_bwd_ref(*targs, tdy, None, 32), want):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)


def test_ssd_scan_autograd_on_cpu_equals_plain_bwd():
    """On CPU tensors autograd differentiates the plain forward; it agrees
    with the plain backward the card's kernel is held to, and launches
    nothing."""
    rng = np.random.default_rng(13)
    _, targs = _ssd_inputs(rng, 2, 96, 4, 16, 2, 16, "float32")
    targs = [t.requires_grad_(True) for t in targs]
    dy = torch.from_numpy(rng.standard_normal((2, 96, 4, 16)).astype(np.float32))
    dst = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    before = kernels.launch_counts()
    y, state = ops.ssd_scan(*targs, chunk=32)
    grads = torch.autograd.grad((y, state), targs, (dy, dst))
    assert kernels.launch_counts() == before
    with torch.no_grad():
        exp = ops.ssd_scan_bwd(*targs, dy, dst, chunk=32)
    for g, w in zip(grads, exp):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_scan_fn_saves_the_inputs_and_calls_the_backward(monkeypatch, use_state):
    """``SsdScanFn`` (the card's autograd wiring) with its kernels replaced
    by the plain versions: autograd's gradients through it equal the plain
    backward's, a final state left out of the loss reaches the backward as
    None, and each backward counts one ``ssd_scan_bwd`` launch."""
    calls = []

    def fake_bwd(x, a_log, b, c, dy, dstate=None, *, chunk=256):
        calls.append(dstate is None)
        tssd.bwd_launches += 1
        return tssd.ssd_scan_bwd_ref(x, a_log, b, c, dy, dstate, chunk)
    monkeypatch.setattr(tssd, "_forward", lambda x, a, b, c, chunk: tssd.ssd_chunked(
        x, a, b, c, chunk))
    monkeypatch.setattr(tssd, "ssd_scan_bwd", fake_bwd)
    rng = np.random.default_rng(14)
    _, targs = _ssd_inputs(rng, 1, 64, 4, 16, 1, 16, "float32")
    targs = [t.requires_grad_(True) for t in targs]
    dy = torch.from_numpy(rng.standard_normal((1, 64, 4, 16)).astype(np.float32))
    dst = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32))
    before = kernels.launch_counts()
    y, state = tssd.SsdScanFn.apply(*targs, 32)
    loss = (y * dy).sum() + ((state * dst).sum() if use_state else 0.0)
    grads = torch.autograd.grad(loss, targs)
    after = kernels.launch_counts()
    assert calls == [not use_state]
    assert after["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    exp = tssd.ssd_scan_bwd_ref(*(t.detach() for t in targs), dy, dst if use_state else None,
                                32)
    for g, w in zip(grads, exp):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,with_state", [
    (2, 64, 8, 32, 1, 16, 32, False),     # the reduced mamba2 train step's shape
    (1, 300, 4, 16, 4, 16, 100, True),    # a group a head, chunk 100 (a ragged 64-row tile)
    (1, 192, 8, 32, 2, 32, 64, True),     # two groups of four heads
    (2, 128, 8, 32, 2, 64, 64, False),    # two groups, no state cotangent
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_stages_compose_to_jax_vjp(B, S, H, P, G, N, chunk, with_state, dtype):
    """The six plain stages of the card's bf16 backward, composed by hand,
    give jax.vjp of the JAX package's ``ssd_chunked`` and ``ssd_scan_bwd_ref``,
    in float32 at 2e-5 (the stages sum in float32 and do not round their
    outputs to bf16); each intermediate has the shape its kernel writes."""
    rng = np.random.default_rng(15)
    jargs, (x, a, b, c) = _ssd_inputs(rng, B, S, H, P, G, N, dtype)
    jdy, dy = _pair(rng, (B, S, H, P), dtype)
    jds, dst = _pair(rng, (B, H, P, N), "float32")
    if not with_state:
        jds, dst = jnp.zeros_like(jds), None
    nc = S // chunk
    states, d_prev, a_cum = tssd.ssd_bwd_chunk_state(x, a, b, c, dy, chunk)
    prev, dstt, d_last = tssd.ssd_bwd_state_passing(states, d_prev, a_cum, dst)
    cb, dcb, d_intra = tssd.ssd_bwd_dcb(x, dy, b, c, a_cum, chunk)
    dx = tssd.ssd_bwd_dx(dy, b, a_cum, cb, dstt)
    db, dc, d_state = tssd.ssd_bwd_dbdc(x, dy, b, c, a_cum, dcb, prev, dstt)
    da = tssd.ssd_bwd_da(d_intra, d_state, d_last)
    assert states.shape == d_prev.shape == prev.shape == dstt.shape == (B, nc, H, P, N)
    assert cb.shape == dcb.shape == (B, nc, G, chunk, chunk)
    assert d_intra.shape == d_state.shape == (B, H, nc, chunk) and d_last.shape == (B, H, nc)
    got = (dx, da, db, dc)
    jargs = tuple(t.astype(jnp.float32) for t in jargs)
    _, vjp = jax.vjp(lambda x, a, b, c: jssd_chunked(x, a, b, c, chunk), *jargs)
    want = vjp((jdy.astype(jnp.float32), jds))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)
    ref_out = ref.ssd_scan_bwd_ref(x.float(), a, b.float(), c.float(), dy.float(), dst, chunk)
    for g, w in zip(got, ref_out):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)


def test_ssd_bwd_dcb_equals_the_per_head_sum():
    """``ssd_bwd_dcb``'s dcb, summed once over a group's heads, equals the
    sum of each head's (dy X^T) o lmat taken head by head; its d_intra is
    each head's row sums less column sums of that head's term times C B^T;
    and dC = dcb B, dB = dcb^T C give the per-head products' sums."""
    rng = np.random.default_rng(16)
    B, S, H, P, G, N, chunk = 1, 128, 6, 16, 2, 32, 64
    _, (x, a, b, c) = _ssd_inputs(rng, B, S, H, P, G, N, "float32")
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    _, _, a_cum = tssd.ssd_bwd_chunk_state(x, a, b, c, dy, chunk)
    cb, dcb, d_intra = tssd.ssd_bwd_dcb(x, dy, b, c, a_cum, chunk)
    nc, rep = S // chunk, H // G
    xb, dyb = x.reshape(B, nc, chunk, H, P), dy.reshape(B, nc, chunk, H, P)
    bb, cc = b.reshape(B, nc, chunk, G, N), c.reshape(B, nc, chunk, G, N)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    want = torch.zeros_like(dcb)
    want_dc, want_db = torch.zeros_like(cc), torch.zeros_like(bb)
    for h in range(H):
        g = h // rep
        lmat = torch.where(lower, torch.exp(a_cum[:, h, :, :, None] - a_cum[:, h, :, None, :]),
                           0.0)                                         # (B, nc, l, s)
        term = torch.einsum("bclp,bcsp->bcls", dyb[:, :, :, h], xb[:, :, :, h]) * lmat
        want[:, :, g] += term
        t = term * cb[:, :, g]
        torch.testing.assert_close(d_intra[:, h], t.sum(-1) - t.sum(-2), atol=2e-5, rtol=2e-5)
        want_dc[:, :, :, g] += torch.einsum("bcls,bcsn->bcln", term, bb[:, :, :, g])
        want_db[:, :, :, g] += torch.einsum("bcls,bcln->bcsn", term, cc[:, :, :, g])
    torch.testing.assert_close(dcb, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(torch.einsum("bcgls,bcsgn->bclgn", dcb, bb), want_dc,
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(torch.einsum("bcgls,bclgn->bcsgn", dcb, cc), want_db,
                               atol=2e-5, rtol=2e-5)


def test_split_bf16_planes_sum_back_to_float32():
    """``split_bf16``'s hi, mid and lo planes (the layout of the backward's
    prev and dst) are bf16 and sum back to the float32 tensor within 2^-24
    of each element's size; a plane is the rounding of what the planes
    before it left over."""
    t = torch.from_numpy(np.random.default_rng(17).standard_normal((3, 2, 16, 32))
                         .astype(np.float32)) * 10.0 ** torch.arange(-3, 3).repeat(16)[:32]
    planes = tssd.split_bf16(t)
    assert planes.shape == (3, 2, 3, 16, 32) and planes.dtype == torch.bfloat16
    back = planes.double().sum(-3)
    assert bool(((back - t.double()).abs() <= t.double().abs() * 2.0 ** -24).all())
    assert torch.equal(planes[..., 0, :, :], t.to(torch.bfloat16))
    assert tssd.bwd_slices(64, 128) == 8 and tssd.bwd_slices(16, 16) == 1


def test_flash_bwd_variants_edit_the_kernel_source():
    """Each text edit of ``tools/bwd_variants.py`` (timed on the card)
    still matches ``csrc/flash_attention_bwd.cu``; the head_dim-256 ones
    match exactly once (its instance alone)."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("bwd_variants", root / "tools" / "bwd_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    for name, edits in tool.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) >= 1 and old != new, name
            if name.endswith("_d256"):
                assert src.count(old) == 1, name


def test_ssd_bwd_variants_edit_the_kernel_source_once():
    """Each text edit of ``tools/ssd_bwd_variants.py`` (timed on the card
    against the unedited backward) matches the CUDA source exactly once, so
    the tool cannot silently time an unedited copy."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("ssd_bwd_variants",
                                                  root / "tools" / "ssd_bwd_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "ssd_scan_bwd.cu").read_text()
    for name, edits in tool.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_rglru_variants_edit_the_kernel_source_once():
    """Each text edit of ``tools/rglru_variants.py`` (timed on the card
    against the unedited forward) matches ``csrc/rglru_scan.cu`` exactly
    once, so the tool cannot silently time an unedited copy."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("rglru_variants",
                                                  root / "tools" / "rglru_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src" / "repro_torch" / "csrc" / "rglru_scan.cu").read_text()
    for name, edits in tool.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


# ---------------------------------------------------------------- rglru
@pytest.mark.parametrize("B,S,W,bt,decay", [
    pytest.param(2, 512, 256, 128, 0.5, id="2-512-256-128"),
    pytest.param(1, 384, 128, 128, 0.5, id="1-384-128-128"),
    pytest.param(2, 256, 512, 256, 0.5, id="2-256-512-256"),
    # near-one decay (a ~ 0.999 a step): a state carries over ~1000 steps, so a
    # carry across the card kernel's rounds or the Pallas kernel's time blocks shows
    pytest.param(1, 1024, 128, 256, 1e-3, id="1-1024-128-256-near-one"),
])
def test_rglru_scan_plain_matches_jax_oracle(B, S, W, bt, decay):
    """Against the JAX oracle and the Pallas kernel (interpret mode) at its
    (bt, min(512, W)) tiling; the port's wrapper takes no tile size. Inputs
    a_log = -decay |N(0, 1)|, b ~ N(0, 1).

    At near-one decay h is a slowly forgetting sum of b that crosses zero,
    and each float32 evaluation carries a rounding error of ~eps sqrt(t) x
    the channel's size, not x |h_t|: 2e-5 of |h_t| does not hold there
    between any two of them, nor between any of them and float64 (port
    plain 1.89x, JAX oracle 1.06x, Pallas 1.07x at the worst element). So
    that case holds all three to a float64 run of the recurrence at 2e-5 of
    (|h_t| + the channel's rms over the sequence)."""
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (B, S, W), "float32")
    jb, tb = _pair(rng, (B, S, W), "float32")
    ja, ta = -jnp.abs(ja) * decay, -ta.abs() * decay
    h, hl = ops.rglru_scan(ta, tb)
    assert h.dtype == hl.dtype == torch.float32
    jax_outs = (jax.jit(jref.rglru_scan_ref)(ja, jb),
                jrglru_pallas(ja, jb, block_t=bt, interpret=True))
    if decay == 0.5:
        for he, hle in jax_outs:
            np.testing.assert_allclose(_np(h), _np(he), atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(_np(hl), _np(hle), atol=2e-5, rtol=2e-5)
        return
    a64 = np.exp(_np(ta).astype(np.float64))
    b64 = _np(tb).astype(np.float64)
    h64 = np.empty((B, S, W))
    acc = np.zeros((B, W))
    for t in range(S):
        acc = a64[:, t] * acc + b64[:, t]
        h64[:, t] = acc
    rms = np.sqrt((h64 ** 2).mean(axis=1))
    for got, got_last in ((h, hl), *jax_outs):
        for g, e, scale in ((_np(got), h64, rms[:, None]), (_np(got_last), h64[:, -1], rms)):
            assert bool((np.abs(g - e) <= 2e-5 + 2e-5 * (np.abs(e) + scale)).all())


@pytest.mark.parametrize("B,S,W", [
    (2, 37, 24),                  # S off 16 (the card kernel's step group)
    (1, 64, 128),
    (3, 130, 40),
    (1, 1, 8),                    # one step: h_{-1} = 0, no a_{t+1}
])
@pytest.mark.parametrize("with_last", [False, True])
def test_rglru_scan_bwd_plain_matches_jax_vjp_and_autograd(B, S, W, with_last):
    """rglru_scan_bwd_ref (the reverse doubling scan, float32, no autograd),
    with and without h_last's cotangent, at 2e-5: against torch autograd
    through rglru_scan_ref, and against jax.vjp of the JAX package's oracle
    ``repro.kernels.ref.rglru_scan_ref`` taken in float64. The oracle divides
    b by the input gate sqrt(1 - a^2) and its scan multiplies it back, so in
    float32 its a_log gradient is the difference of two terms of size
    |b| gate' / gate (~100 |b| where a nears 1) that cancel only to noise
    above 2e-5; in float64 that noise is ~1e-13."""
    rng = np.random.default_rng(12)
    a = (-np.abs(rng.standard_normal((B, S, W))) * 0.5).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    dl = rng.standard_normal((B, W)).astype(np.float32) if with_last else None
    tdh, tdl = torch.from_numpy(dh), None if dl is None else torch.from_numpy(dl)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    h, hl = ref.rglru_scan_ref(ta, tb)
    da, db = ref.rglru_scan_bwd_ref(ta.detach(), h.detach(), tdh, tdl)
    assert da.dtype == db.dtype == torch.float32
    loss = (h * tdh).sum() + (0 if tdl is None else (hl * tdl).sum())
    auto = torch.autograd.grad(loss, (ta, tb), allow_unused=True)   # S = 1 does not use a_log
    auto = [torch.zeros_like(x) if g is None else g for g, x in zip(auto, (ta, tb))]
    with jax.enable_x64(True):
        _, vjp = jax.vjp(jref.rglru_scan_ref, jnp.asarray(a, jnp.float64),
                         jnp.asarray(b, jnp.float64))
        jgrads = [np.asarray(g) for g in vjp((jnp.asarray(dh, jnp.float64),
                                              jnp.zeros((B, W), jnp.float64) if dl is None
                                              else jnp.asarray(dl, jnp.float64)))]
    for exp in (auto, jgrads):
        for got, e in zip((da, db), exp):
            np.testing.assert_allclose(_np(got), _np(e), atol=2e-5, rtol=2e-5)


def test_rglru_scan_bwd_plain_reads_a_missing_cotangent_as_zero():
    """dh None is a zero dh (only h_last used); dh_last None a zero dh_last."""
    rng = np.random.default_rng(13)
    a = torch.from_numpy((-np.abs(rng.standard_normal((2, 21, 16))) * 0.5).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 21, 16)).astype(np.float32))
    dl = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    for got, exp in zip(ops.rglru_scan_bwd(a, h, None, dl),
                        ref.rglru_scan_bwd_ref(a, h, torch.zeros_like(h), dl)):
        assert torch.equal(got, exp)
    for got, exp in zip(ops.rglru_scan_bwd(a, h, h, None),
                        ref.rglru_scan_bwd_ref(a, h, h, torch.zeros_like(dl))):
        torch.testing.assert_close(got, exp, atol=0, rtol=0)


def test_rglru_scan_fn_saves_a_log_and_h_and_calls_the_backward(monkeypatch):
    """RglruScanFn on stand-ins for the kernels (the plain versions, on CPU
    tensors): it saves a_log and the forward's h, hands the backward both
    cotangents (None where autograd leaves one out) and returns its
    (da_log, db); its gradients equal autograd's through the plain scan."""
    from repro_torch.kernels import rglru_scan as trg
    calls = []

    def fake_bwd(a_log, h, dh, dh_last=None):
        calls.append((dh is None, dh_last is None))
        return ref.rglru_scan_bwd_ref(a_log, h, dh, dh_last)
    monkeypatch.setattr(trg, "_forward", lambda a_log, b: ref.rglru_scan_ref(a_log, b))
    monkeypatch.setattr(trg, "rglru_scan_bwd", fake_bwd)
    rng = np.random.default_rng(14)
    a0 = torch.from_numpy((-np.abs(rng.standard_normal((2, 33, 8))) * 0.5).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal((2, 33, 8)).astype(np.float32))
    for use_h, use_last in ((True, False), (False, True), (True, True)):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        h, hl = trg.RglruScanFn.apply(a, b)
        loss = (h.square().sum() if use_h else 0) + (hl.sum() if use_last else 0)
        got = torch.autograd.grad(loss, (a, b))
        ar, br = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        hr, hlr = ref.rglru_scan_ref(ar, br)
        exp = torch.autograd.grad((hr.square().sum() if use_h else 0)
                                  + (hlr.sum() if use_last else 0), (ar, br))
        assert calls[-1] == (not use_h, not use_last)
        for g, e in zip(got, exp):
            torch.testing.assert_close(g, e, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 4, 64)).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([40], dtype=torch.int32)
    a_log = -q[..., 0].abs()
    bc = k[:, :, :1, :32]
    before = kernels.launch_counts()
    out_f = ops.flash_attention(q, k, v, window=16)
    out_d = ops.decode_attention(q[:, :1], k, v, lens, window=16)
    out_s = ops.ssd_scan(q, a_log, bc, bc, chunk=16)
    out_r = ops.rglru_scan(a_log, q[..., 1])
    assert kernels.launch_counts() == before
    assert torch.equal(out_f, ref.flash_attention_ref(q, k, v, window=16))
    assert torch.equal(out_d, ref.decode_attention_ref(q[:, :1], k, v, lens, window=16))
    for got, exp in zip(out_s + out_r, ref.ssd_scan_ref(q, a_log, bc, bc, 16)
                        + ref.rglru_scan_ref(a_log, q[..., 1])):
        assert torch.equal(got, exp)
