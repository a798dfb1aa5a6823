"""The port's encoder-decoder (``repro_torch.models.encdec.EncDecLM``,
whisper_small's backbone) against the JAX package's ``EncDecLM``.

Both packages start from one set of weights: the JAX init through numpy,
with every attention's wq and wk scaled by 0.3 (as tests/test_torch_models.py
does for the decoder-only models: the reference init makes the attention of
these narrow models nearly one-hot, and a last-bit difference then grows
from layer to layer). Frames and tokens come from a numpy seed.
Tolerances are test_torch_models.py's: float32 whole-model outputs at 1e-4,
bfloat16 at a relative L2 error of 6e-2 with the same dtype at every output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models.encdec import EncDecLM as JEncDecLM
from repro_torch.configs import reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.convert import from_numpy
from test_torch_models import BF16_MODEL, MODEL, _close, walk_close

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

B = 2


def _models(**overrides):
    """Both whisper models with one set of weights (wq, wk scaled by 0.3)."""
    jcfg = dataclasses.replace(j_reduced("whisper_small"), **overrides)
    tcfg = dataclasses.replace(reduced_config("whisper_small"), **overrides)
    jm = JEncDecLM(jcfg)
    weights = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    for stack, attns in (("enc", ("attn",)), ("dec", ("self_attn", "cross_attn"))):
        for attn in attns:
            for name in ("wq", "wk"):
                w = weights[stack][attn][name]
                weights[stack][attn][name] = (w * np.float32(0.3)).astype(w.dtype)
    tm = build_model(tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, weights), tm, from_numpy(weights, device="cpu")


def _frames(cfg, n=None, seed=11):
    """Encoder frames as numpy float32: (B, n or enc_seq, d_model)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n or cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same float32 numbers as a jax array and a tensor of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def test_build_model_gives_the_encoder_decoder():
    m = build_model(reduced_config("whisper_small"), device="cpu")
    assert isinstance(m, EncDecLM)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        EncDecLM(reduced_config("qwen3_32b"), device="cpu")


def test_init_is_seeded_and_laid_out_like_jax():
    jm, jparams, tm, _ = _models()
    a, b = (tm.init(torch.Generator().manual_seed(3)) for _ in range(2))
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jparams)

    def walk(t, u, s):
        if isinstance(t, dict):
            assert t.keys() == u.keys() == s.keys()
            for key in t:
                walk(t[key], u[key], s[key])
        else:
            assert torch.equal(t, u)
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == s
    walk(a, b, shapes)


@pytest.mark.parametrize("overrides,n_frames", [({}, None), ({}, 20),
                                                ({"dtype": "bfloat16"}, None)])
def test_encode_matches_jax(overrides, n_frames):
    """The encoder (non-causal plain attention over the frames plus their
    positions), also over fewer frames than enc_seq."""
    jm, jparams, tm, tparams = _models(**overrides)
    dt = tm.cfg.dtype
    jf, tf = _both(_frames(tm.cfg, n_frames), dt)
    _close(tm.encode(tparams, tf, remat="none"), jm.encode(jparams, jf, remat="none"),
           BF16_MODEL if dt == "bfloat16" else MODEL)


@pytest.mark.parametrize("prompt,overrides", [
    (16, {}),
    # the decoder's self-attention above attn_chunk: the flash kernel's plain
    # version in the port, the query-chunked attention in the JAX package
    (128, {"attn_chunk": 64}),
    (16, {"dtype": "bfloat16"}),
])
def test_apply_loss_prefill_decode_match_jax(prompt, overrides):
    """Logits, the loss and its parts, prefill, 4 decode steps and every
    cache leaf (the self K/V and the cross K/V of the encoder output); no
    kernel launches on the CPU."""
    steps = 4
    jm, jparams, tm, tparams = _models(**overrides)
    cfg = tm.cfg
    tol = BF16_MODEL if cfg.dtype == "bfloat16" else MODEL
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (B, prompt + steps + 1)).astype(np.int32)
    jf, tf = _both(_frames(cfg), cfg.dtype)
    before = launch_counts()

    logits, aux = tm.apply(tparams, torch.from_numpy(toks[:, :prompt]), encoder_frames=tf,
                           remat="none")
    jlogits, jaux = jm.apply(jparams, jnp.asarray(toks[:, :prompt]), encoder_frames=jf,
                             remat="none")
    _close(logits[..., :cfg.vocab_size], jlogits[..., :cfg.vocab_size], tol)
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    if cfg.padded_vocab != cfg.vocab_size:
        assert float(logits[..., cfg.vocab_size:].max()) < -1e30

    batch = {"tokens": toks[:, :prompt], "labels": toks[:, 1:prompt + 1]}
    loss, parts = tm.loss(tparams, {**{k: torch.from_numpy(v) for k, v in batch.items()},
                                    "encoder_frames": tf}, remat="none")
    jloss, jparts = jm.loss(jparams, {**jax.tree.map(jnp.asarray, batch),
                                      "encoder_frames": jf}, remat="none")
    _close(loss, jloss, tol)
    for key in ("nll", "aux"):
        _close(parts[key], jparts[key], tol)

    max_len = prompt + steps
    cache = tm.init_cache(B, max_len)
    with torch.no_grad():
        out, cache2 = tm.prefill(tparams, torch.from_numpy(toks[:, :prompt]), cache,
                                 encoder_frames=tf)
    assert cache2 is cache                       # written in place
    jout, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :prompt]), jm.init_cache(B, max_len),
                              encoder_frames=jf)
    _close(out, jout, tol)
    jdecode = jax.jit(jm.decode)
    for i in range(steps):
        pos = np.full((B,), prompt + i, np.int32)
        tok = toks[:, prompt + i:prompt + i + 1]
        with torch.no_grad():
            out, cache = tm.decode(tparams, torch.from_numpy(tok), cache, torch.from_numpy(pos))
        jout, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        _close(out, jout, tol)
    walk_close(cache, jax.tree.map(np.asarray, jcache), tol)
    assert launch_counts() == before             # CPU tensors launch no kernel


def test_decode_matches_a_fresh_prefill():
    """Prefill 12 tokens and decode 6 more, against one prefill of all 18:
    the last logits agree (the cross cache is written once, at prefill)."""
    _, _, tm, tparams = _models()
    cfg = tm.cfg
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 18)))
    frames = torch.from_numpy(_frames(cfg))
    with torch.no_grad():
        _, cache = tm.prefill(tparams, toks[:, :12], tm.init_cache(B, 18), encoder_frames=frames)
        for i in range(12, 18):
            out, cache = tm.decode(tparams, toks[:, i:i + 1], cache,
                                   torch.full((B,), i, dtype=torch.int32))
        fresh, _ = tm.prefill(tparams, toks, tm.init_cache(B, 18), encoder_frames=frames)
    torch.testing.assert_close(out, fresh, **MODEL)


def test_remat_full_gives_the_gradients_of_none():
    """``remat="full"`` (a checkpoint a layer, encoder and decoder) changes
    no gradient."""
    _, _, tm, tparams = _models()
    cfg = tm.cfg
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "encoder_frames": torch.from_numpy(_frames(cfg))}
    leaves = [tparams["enc"]["attn"]["wq"], tparams["dec"]["cross_attn"]["wk"],
              tparams["dec"]["mlp"]["w_up"], tparams["embed"], tparams["enc_pos"]]
    grads = {}
    for remat in ("full", "none"):
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tm.loss(tparams, batch, remat=remat)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_frames_of_another_dtype_raise_where_the_jax_package_fails():
    """float32 frames into a bfloat16 model: the JAX package carries the
    encoder's sum in float32 and fails in its layer scan; the port raises a
    TypeError naming both dtypes before computing anything."""
    jm, jparams, tm, tparams = _models(dtype="bfloat16", n_layers=1, n_enc_layers=1)
    frames = _frames(tm.cfg)
    toks = np.zeros((B, 4), np.int32)
    with pytest.raises(TypeError):
        jm.apply(jparams, jnp.asarray(toks), encoder_frames=jnp.asarray(frames), remat="none")
    with pytest.raises(TypeError, match="float32.*bfloat16"):
        tm.apply(tparams, torch.from_numpy(toks), encoder_frames=torch.from_numpy(frames))
    with pytest.raises(TypeError, match="float32.*bfloat16"):
        tm.prefill(tparams, torch.from_numpy(toks), tm.init_cache(B, 8),
                   encoder_frames=torch.from_numpy(frames))


def test_prefill_refuses_frames_the_cross_cache_cannot_hold():
    _, _, tm, tparams = _models()
    with pytest.raises(ValueError, match="cross cache holds"):
        tm.prefill(tparams, torch.zeros((B, 4), dtype=torch.int32), tm.init_cache(B, 8),
                   encoder_frames=torch.from_numpy(_frames(tm.cfg, 20)))
