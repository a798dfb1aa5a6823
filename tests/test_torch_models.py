"""The port's model code (repro_torch.models) against the JAX package's.

Inputs come from a numpy seed; whole models share weights through
``repro_torch.models.convert``. Tolerances: float32 atol/rtol 2e-5 for
single functions (the JAX package's kernel tolerance), 1e-4 for whole-model
logits, where several layers of f32 sums in another order add up.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.transformer import LM as JLM
from repro_torch.configs import reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, common as tcommon
from repro_torch.models.convert import from_numpy

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------- common
def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _arr(rng, 2, 5, 64), _arr(rng, 64, scale=0.1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), F32)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _arr(rng, 2, 40, 3, 16)
    pos = np.arange(40)[None, :] + np.array([[0], [7]])
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), F32)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation(name):
    x = _arr(np.random.default_rng(2), 257, scale=3.0)
    _close(tcommon.activation(name)(torch.from_numpy(x)),
           jcommon.activation(name)(jnp.asarray(x)), F32)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=7),
    dict(causal=True, prefix_len=5),
    dict(causal=True, offset=16),
    dict(causal=False),
])
def test_gqa_attention(kw):
    rng = np.random.default_rng(3)
    S = 16
    T = S + kw.get("offset", 0)
    q, k, v = _arr(rng, 2, S, 8, 16), _arr(rng, 2, T, 2, 16), _arr(rng, 2, T, 2, 16)
    _close(tattn.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           jattn.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw), F32)


@pytest.mark.parametrize("kw", [dict(causal=True, window=20), dict(causal=True, prefix_len=6),
                                dict(causal=False)])
def test_gqa_attention_chunked(kw):
    rng = np.random.default_rng(4)
    q, k, v = _arr(rng, 1, 64, 4, 16), _arr(rng, 1, 64, 1, 16), _arr(rng, 1, 64, 1, 16)
    _close(tattn.gqa_attention_chunked(*map(torch.from_numpy, (q, k, v)), q_chunk=16, **kw),
           jattn.gqa_attention_chunked(*map(jnp.asarray, (q, k, v)), q_chunk=16, **kw), F32)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_ref(window):
    rng = np.random.default_rng(5)
    q, k, v = _arr(rng, 3, 1, 8, 16), _arr(rng, 3, 24, 4, 16), _arr(rng, 3, 24, 4, 16)
    lens = np.array([1, 13, 24], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    args_j = [jnp.asarray(a) for a in (q, k, v, lens)]
    _close(tattn.decode_attention_ref(*args_t, window=window),
           jattn.decode_attention_ref(*args_j, window=window), F32)
    _close(tattn.decode_attention(*args_t, window=window),
           jattn.decode_attention(*args_j, window=window), F32)


# ---------------------------------------------------------------- whole model
def _models(arch, **overrides):
    """Both models with one set of weights: the JAX package's init, as numpy.

    The JAX init draws wq and wk with std heads**-0.5, which makes the
    attention logits of these narrow models large and the softmax nearly
    one-hot; without qk-norm a last-bit difference in the logits then grows
    ~6x per layer. Scaling wq and wk by 0.3 in the shared numpy weights keeps
    the comparison well conditioned; both packages get the same numbers."""
    jcfg = dataclasses.replace(j_reduced(arch), **overrides)
    tcfg = dataclasses.replace(reduced_config(arch), **overrides)
    jm = JLM(jcfg)
    weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    mixer = weights["stack"]["u0"]["mixer"]
    for name in ("wq", "wk"):
        mixer[name] = mixer[name] * np.float32(0.3)
    tm = build_model(tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, weights), tm, from_numpy(weights)


@pytest.mark.parametrize("arch,prompt,overrides", [
    ("qwen3_32b", 16, {}),                  # qk-norm
    ("granite_8b", 16, {}),
    ("granite_20b", 16, {}),                # MQA, non-gated gelu
    ("h2o_danube_1_8b", 48, {}),            # window 32: prefill rolls the ring
    ("qwen3_32b", 128, {"attn_chunk": 64}),  # chunked path, flash dispatch
])
def test_lm_apply_prefill_decode_match_jax(arch, prompt, overrides):
    B, steps = 2, 4
    jm, jparams, tm, tparams = _models(arch, **overrides)
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, prompt + steps)).astype(np.int32)

    logits, _ = tm.apply(tparams, torch.from_numpy(toks[:, :prompt]))
    jlogits, _ = jm.apply(jparams, jnp.asarray(toks[:, :prompt]), remat="none")
    _close(logits[..., :cfg.vocab_size], jlogits[..., :cfg.vocab_size], MODEL)
    assert float(logits[..., cfg.vocab_size:].max()) < -1e30 if \
        cfg.padded_vocab != cfg.vocab_size else True

    max_len = prompt + steps
    cache = tm.init_cache(B, max_len)
    jcache = jm.init_cache(B, max_len)
    before = launch_counts()
    with torch.no_grad():
        out, cache = tm.prefill(tparams, torch.from_numpy(toks[:, :prompt]), cache)
    jout, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :prompt]), jcache)
    _close(out, jout, MODEL)
    jdecode = jax.jit(jm.decode)          # one compile for the four steps
    for i in range(steps):
        pos = np.full((B,), prompt + i, np.int32)
        tok = toks[:, prompt + i:prompt + i + 1]
        with torch.no_grad():
            out, cache = tm.decode(tparams, torch.from_numpy(tok), cache, torch.from_numpy(pos))
        jout, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        _close(out, jout, MODEL)
    # the first layer's cache (ring layout included) depends on the embedding alone
    for name in ("k", "v"):
        _close(cache["stack"]["u0"][name][0], jcache["stack"]["u0"][name][0], F32)
    assert launch_counts() == before          # CPU tensors launch no kernel


def test_non_dense_families_name_their_roadmap_item():
    for arch in ("mamba2_780m", "recurrentgemma_9b", "olmoe_1b_7b", "deepseek_v2_236b",
                 "whisper_small", "paligemma_3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(reduced_config(arch), device="cpu")


def test_init_is_seeded_and_laid_out_like_jax():
    jm, jparams, tm, _ = _models("qwen3_32b")
    a = tm.init(torch.Generator().manual_seed(3))
    b = tm.init(torch.Generator().manual_seed(3))
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)

    def walk(t, u, s):
        if isinstance(t, dict):
            assert t.keys() == u.keys() == s.keys()
            for key in t:
                walk(t[key], u[key], s[key])
        else:
            assert torch.equal(t, u) and tuple(t.shape) == s
    walk(a, b, shapes)
