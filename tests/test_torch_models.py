"""The port's model code (repro_torch.models) against the JAX package's.

Inputs come from a numpy seed; whole models share weights through
``repro_torch.models.convert``. Tolerances: float32 atol/rtol 2e-5 for
single functions (the JAX package's kernel tolerance), 1e-4 for whole-model
logits, where several layers of f32 sums in another order add up.

bfloat16 runs are held to the same dtype at every output and state, and to
a relative L2 error: 2e-2 for one block, 6e-2 for a whole model. The two
packages cannot agree to the last bit there: XLA on the CPU keeps excess
precision between bf16 operations (``xla_allow_excess_precision``), and
composite activations (silu, tanh-gelu) round once in PyTorch and after
each step in JAX; each such rounding is 2**-9 relative, and a block holds
several (0.3-0.9% measured on these inputs, 3-4% after a reduced model).
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
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.transformer import LM as JLM
from repro_torch.configs import reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_numpy

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

F32 = dict(atol=2e-5, rtol=2e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)
BF16_BLOCK = dict(rel_l2=2e-2)
BF16_MODEL = dict(rel_l2=6e-2)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol):
    if "rel_l2" in tol:             # bfloat16: the same dtype, within a relative L2 error
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (t.dtype, j.dtype)
        a, b = t.detach().float().numpy(), np.asarray(j, np.float32)
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        assert rel <= tol["rel_l2"], f"relative L2 error {rel:.3e} > {tol['rel_l2']}"
        return
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------- common
def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _arr(rng, 2, 5, 64), _arr(rng, 64, scale=0.1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), F32)


def test_layer_norm():
    rng = np.random.default_rng(0)
    x, s, b = _arr(rng, 2, 5, 64, scale=3.0), _arr(rng, 64, scale=0.1), _arr(rng, 64, scale=0.1)
    x = x + np.float32(2.0)               # a mean far from 0
    for eps in (1e-5, 1e-6):
        _close(tcommon.layer_norm(*map(torch.from_numpy, (x, s, b)), eps),
               jcommon.layer_norm(*map(jnp.asarray, (x, s, b)), eps), F32)
    xb = torch.from_numpy(x).bfloat16()
    out = tcommon.layer_norm(xb, torch.from_numpy(s), torch.from_numpy(b))
    _close(out, jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b)),
           BF16_BLOCK)


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


# ---------------------------------------------------------------- mamba-2, rg-lru
def _block_weights(init, arch, dtype=jnp.float32):
    """One block's JAX init for ``arch``'s reduced config, as numpy, and the
    same numbers as torch tensors."""
    cfg = j_reduced(arch)
    w = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1), cfg, dtype))
    return cfg, reduced_config(arch), jax.tree.map(jnp.asarray, w), from_numpy(w, device="cpu")


def _as(x: np.ndarray, dtype: str):
    """The same float32 numbers as a jax array and a tensor of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scanned_matches_chunked(with_h0):
    rng = np.random.default_rng(7)
    B, S, H, P, G, N, chunk = 2, 96, 4, 8, 2, 16, 16
    x, b, c = _arr(rng, B, S, H, P, scale=0.3), _arr(rng, B, S, G, N), _arr(rng, B, S, G, N)
    a = -np.abs(_arr(rng, B, S, H, scale=0.3))
    h0 = _arr(rng, B, H, P, N) if with_h0 else None
    t = [torch.from_numpy(v) for v in (x, a, b, c)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    ys, hs = tssm.ssd_scanned(*t, chunk, th0)
    yc, hc = tssm.ssd_chunked(*t, chunk, h0=th0)
    _close(ys, yc.numpy(), F32)
    _close(hs, hc.numpy(), F32)
    yj, hj = jax.jit(jssm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, a, b, c)), chunk, None if h0 is None else jnp.asarray(h0))
    _close(yc, yj, F32)
    _close(hc, hj, F32)


@pytest.mark.parametrize("S", [64, 1])
def test_apply_mamba2_with_and_without_state_matches_jax(S):
    """A carried state through ``apply_mamba2`` (S = 64: two chunks of 32 on
    ssd_chunked's h0 path) and the single-token decode update, against the
    JAX functions; prefill from zero state is in the whole-model test."""
    jcfg, tcfg, jp, tp = _block_weights(jssm.init_mamba2, "mamba2_780m")
    rng = np.random.default_rng(8)
    x = _arr(rng, 2, S, jcfg.d_model)
    conv_dim = jcfg.d_inner + 2 * jcfg.ssm_ngroups * jcfg.ssm_state
    state = {"ssm": _arr(rng, 2, jcfg.ssm_nheads, jcfg.ssm_headdim, jcfg.ssm_state, scale=0.1),
             "conv": _arr(rng, 2, jcfg.ssm_conv - 1, conv_dim)}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    if S == 1:
        out, new = tssm.apply_mamba2_decode(tp, torch.from_numpy(x), tcfg, tstate)
        jout, jnew = jax.jit(jssm.apply_mamba2_decode, static_argnums=2)(
            jp, jnp.asarray(x), jcfg, jstate)
    else:
        out, new = tssm.apply_mamba2(tp, torch.from_numpy(x), tcfg, tstate)
        jout, jnew = jax.jit(jssm.apply_mamba2, static_argnums=2)(jp, jnp.asarray(x), jcfg,
                                                                  jstate)
    _close(out, jout, F32)
    for k in ("ssm", "conv"):
        _close(new[k], jnew[k], F32)


@pytest.mark.parametrize("S,with_state", [(64, False), (40, False), (1, True), (5, True)])
def test_apply_rglru_with_and_without_state_matches_jax(S, with_state):
    jcfg, tcfg, jp, tp = _block_weights(jrglru.init_rglru, "recurrentgemma_9b")
    rng = np.random.default_rng(9)
    x = _arr(rng, 2, S, jcfg.d_model)
    w = jcfg.lru_dim
    state = {"lru": _arr(rng, 2, w), "conv": _arr(rng, 2, jcfg.conv_width - 1, w)} \
        if with_state else None
    out, new = trglru.apply_rglru(tp, torch.from_numpy(x), tcfg,
                                  None if state is None else
                                  {k: torch.from_numpy(v) for k, v in state.items()})
    jout, jnew = jax.jit(jrglru.apply_rglru, static_argnums=2)(
        jp, jnp.asarray(x), jcfg, None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    _close(out, jout, F32)
    for k in ("lru", "conv"):
        _close(new[k], jnew[k], F32)


@pytest.mark.parametrize("block,S,with_state", [
    ("mamba2", 64, False),          # prefill from zero state: ssd_chunked, xdt rounded
    ("mamba2", 1, True),            # the decode update: f32 state, bf16 output
    ("rglru", 64, False),
    ("rglru", 5, True),
])
def test_blocks_in_bfloat16_match_jax(block, S, with_state):
    """The served dtype's cast points: every output and state in the JAX
    package's dtype (states f32, activations bf16), values within bf16
    tolerance."""
    if block == "mamba2":
        jcfg, tcfg, jp, tp = _block_weights(jssm.init_mamba2, "mamba2_780m", jnp.bfloat16)
        conv_dim = jcfg.d_inner + 2 * jcfg.ssm_ngroups * jcfg.ssm_state
        shapes = {"ssm": (jcfg.ssm_nheads, jcfg.ssm_headdim, jcfg.ssm_state),
                  "conv": (jcfg.ssm_conv - 1, conv_dim)}
        key = "ssm"
        jfn, tfn = ((jssm.apply_mamba2_decode, tssm.apply_mamba2_decode) if S == 1 else
                    (jssm.apply_mamba2, tssm.apply_mamba2))
    else:
        jcfg, tcfg, jp, tp = _block_weights(jrglru.init_rglru, "recurrentgemma_9b", jnp.bfloat16)
        shapes = {"lru": (jcfg.lru_dim,), "conv": (jcfg.conv_width - 1, jcfg.lru_dim)}
        key = "lru"
        jfn, tfn = jrglru.apply_rglru, trglru.apply_rglru
    rng = np.random.default_rng(10)
    jx, tx = _as(_arr(rng, 2, S, jcfg.d_model), "bfloat16")
    jstate = tstate = None
    if with_state:      # the recurrent state in f32, the conv tail in the model's dtype
        pairs = {k: _as(_arr(rng, 2, *shape, scale=0.1 if k == "ssm" else 1.0),
                        "float32" if k == key else "bfloat16") for k, shape in shapes.items()}
        jstate = {k: v[0] for k, v in pairs.items()}
        tstate = {k: v[1] for k, v in pairs.items()}
    out, new = tfn(tp, tx, tcfg, tstate)
    jout, jnew = jax.jit(jfn, static_argnums=2)(jp, jx, jcfg, jstate)
    _close(out, jout, BF16_BLOCK)
    assert new[key].dtype == torch.float32
    for k in (key, "conv"):
        _close(new[k], jnew[k], BF16_BLOCK)


# ---------------------------------------------------------------- whole model
def _models(arch, wv_fan_in_d_model=False, **overrides):
    """Both models with one set of weights: the JAX package's init, as numpy.

    The JAX init draws wq and wk with std heads**-0.5, which makes the
    attention logits of these narrow models large and the softmax nearly
    one-hot; without qk-norm a last-bit difference in the logits then grows
    ~6x per layer. Scaling wq and wk by 0.3 in the shared numpy weights keeps
    the comparison well conditioned; both packages get the same numbers.
    With ``wv_fan_in_d_model`` wv is scaled by d_model**-0.5 too: the JAX init
    reads its fan-in from the KV-head axis, 1 in an MQA model, so V comes out
    with std ~sqrt(d_model) (entries up to ~40 in the reduced paligemma), and
    the V cache's float32 roundoff alone reaches an elementwise 1e-4."""
    jcfg = dataclasses.replace(j_reduced(arch), **overrides)
    tcfg = dataclasses.replace(reduced_config(arch), **overrides)
    jm = JLM(jcfg)
    weights = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    for group in ("stack", "tail"):
        for block in weights.get(group, {}).values():
            scales = {"wq": 0.3, "wk": 0.3}
            if wv_fan_in_d_model:
                scales["wv"] = jcfg.d_model ** -0.5
            for name, scale in scales.items():
                if name in block["mixer"]:
                    w = block["mixer"][name]
                    block["mixer"][name] = (w * np.float32(scale)).astype(w.dtype)
    tm = build_model(tcfg, device="cpu")
    return jm, jax.tree.map(jnp.asarray, weights), tm, from_numpy(weights, device="cpu")


# A routing decision of a bf16 MoE layer can flip between the two packages on
# a near-tie: the router product is rounded to bf16, and the layer's input
# already differs by the bf16 roundings of the layers before (up to ~2.4% in
# the router's probabilities, measured on these models). A flip is a near-tie
# when the probability of each expert that differs lies within 2**-5 (four
# bf16 steps, chip_smoke's bf16 bound) of the k-th largest; a token that
# flipped then carries another state through the layers after, where its
# routing is no longer compared.
NEAR_TIE = 2.0 ** -5


def _log_routing(monkeypatch):
    """Each MoE layer's top-k experts in both packages, one (T, K) entry a
    layer call in execution order: the port's from its ``route``, the JAX
    package's with its probabilities, by a debug callback beside its
    ``apply_moe`` that repeats its routing's ops on the same (G, Tl)
    grouping."""
    tlog, jlog = [], []
    route = tmlp.route

    def logged_route(p, xg, cfg):
        r = route(p, xg, cfg)
        tlog.append(r.experts.reshape(-1, cfg.experts_per_token).numpy())
        return r
    monkeypatch.setattr(tmlp, "route", logged_route)
    apply_moe = jtransformer.apply_moe

    def logged_moe(p, x, cfg):
        T, D = x.shape[0] * x.shape[1], x.shape[2]
        G = jmlp.dispatch_groups(T, cfg)
        xg = x.reshape(G, T // G, D)
        probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, p["router"].astype(x.dtype))
                               .astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, cfg.experts_per_token)[1]
        jax.debug.callback(lambda pr, ix: jlog.append((np.asarray(pr).reshape(T, -1),
                                                       np.asarray(ix).reshape(T, -1))),
                           probs, top, ordered=True)
        return apply_moe(p, x, cfg)
    monkeypatch.setattr(jtransformer, "apply_moe", logged_moe)
    return tlog, jlog


def _routed_alike(logs, B, S) -> np.ndarray:
    """(B, S) mask of the tokens that every logged MoE layer routed alike in
    both packages; asserts that each token's first flip is a near-tie.
    Empties the logs."""
    tlog, jlog = logs
    assert tlog and len(tlog) == len(jlog)
    flipped = np.zeros(B * S, bool)
    for ti, (jp, ji) in zip(tlog, jlog):
        K = ti.shape[-1]
        kth = np.sort(jp, axis=-1)[:, -K]
        for t in np.nonzero(np.any(np.sort(ti, -1) != np.sort(ji, -1), axis=-1))[0]:
            if not flipped[t]:
                for e in set(ti[t]) ^ set(ji[t]):
                    gap = abs(jp[t, e] - kth[t])
                    assert gap <= NEAR_TIE * kth[t], f"token {t} expert {e}: gap {gap:.3e} " \
                        f"to the k-th {kth[t]:.3e} is no near-tie"
            flipped[t] = True
    tlog.clear()
    jlog.clear()
    return ~flipped.reshape(B, S)


@pytest.mark.parametrize("arch,prompt,overrides", [
    ("qwen3_32b", 16, {}),                  # qk-norm
    ("granite_8b", 16, {}),
    ("granite_20b", 16, {}),                # MQA, non-gated gelu
    ("h2o_danube_1_8b", 48, {}),            # window 32: prefill rolls the ring
    ("qwen3_32b", 128, {"attn_chunk": 64}),  # chunked path, flash dispatch
    ("mamba2_780m", 64, {}),                # 2 chunks of 32: ssd_chunked
    ("mamba2_780m", 192, {}),               # 6 chunks: ssd_scanned
    ("recurrentgemma_9b", 64, {}),          # rec/local_attn units + tail; prompt past
                                            # window 32: prefill rolls the ring
    ("mamba2_780m", 64, {"dtype": "bfloat16"}),        # the served dtype's cast points
    ("recurrentgemma_9b", 64, {"dtype": "bfloat16"}),
    # the full config's head_dim 80 (the flash and decode kernels' d = 80 on
    # the card); window 32 < prompt 48
    ("h2o_danube_1_8b", 48, {"head_dim": 80, "n_layers": 2}),
    ("h2o_danube_1_8b", 48, {"head_dim": 80, "n_layers": 2, "dtype": "bfloat16"}),
    # MoE: 3 moe layers; 2 x 16 tokens route in 16 groups of 2 at the
    # reference's capacity (C = 2), 2 x 128 in 32 groups of 8 (C = 6): drops
    ("olmoe_1b_7b", 16, {}),
    ("olmoe_1b_7b", 128, {"attn_chunk": 64}),              # flash dispatch
    ("olmoe_1b_7b", 48, {"dtype": "bfloat16"}),
    # MLA + shared experts, the dense-first tail; above attn_chunk the
    # query-chunked MLA prefill (chunks of 16)
    ("deepseek_v2_236b", 16, {}),
    ("deepseek_v2_236b", 128, {"attn_chunk": 64}),
    ("deepseek_v2_236b", 48, {"dtype": "bfloat16"}),
])
def test_lm_apply_prefill_decode_match_jax(arch, prompt, overrides, monkeypatch):
    """Logits, aux loss, prefill, 4 decode steps and every cache leaf. A
    bfloat16 MoE model is compared on the tokens that every MoE layer routed
    alike in both packages, each flip a near-tie (``_routed_alike``)."""
    B, steps = 2, 4
    tol = BF16_MODEL if overrides.get("dtype") == "bfloat16" else MODEL
    jm, jparams, tm, tparams = _models(arch, **overrides)
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (B, prompt + steps)).astype(np.int32)
    logs = _log_routing(monkeypatch) if cfg.n_experts and tol is BF16_MODEL else None

    def alike(S):
        return np.ones((B, S), bool) if logs is None else _routed_alike(logs, B, S)

    logits, aux = tm.apply(tparams, torch.from_numpy(toks[:, :prompt]))
    jlogits, jaux = jm.apply(jparams, jnp.asarray(toks[:, :prompt]), remat="none")
    keep = alike(prompt)
    _close(logits[..., :cfg.vocab_size][torch.from_numpy(keep)],
           np.asarray(jlogits[..., :cfg.vocab_size])[keep], tol)
    _close(aux, jaux, MODEL if tol is MODEL else dict(atol=1e-3, rtol=2e-2))
    assert (float(aux) > 0) == bool(cfg.n_experts)       # the MoE layers' load-balance loss
    assert float(logits[..., cfg.vocab_size:].max()) < -1e30 if \
        cfg.padded_vocab != cfg.vocab_size else True

    max_len = prompt + steps
    cache = tm.init_cache(B, max_len)
    jcache = jm.init_cache(B, max_len)
    before = launch_counts()
    with torch.no_grad():
        out, cache = tm.prefill(tparams, torch.from_numpy(toks[:, :prompt]), cache)
    jout, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :prompt]), jcache)
    rows = alike(prompt)
    _close(out[torch.from_numpy(rows[:, -1])], np.asarray(jout)[rows[:, -1]], tol)
    kept = [rows]                           # each position's token routed alike
    jdecode = jax.jit(jm.decode)          # one compile for the four steps
    for i in range(steps):
        pos = np.full((B,), prompt + i, np.int32)
        tok = toks[:, prompt + i:prompt + i + 1]
        with torch.no_grad():
            out, cache = tm.decode(tparams, torch.from_numpy(tok), cache, torch.from_numpy(pos))
        jout, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        kept.append(alike(1))
        _close(out[torch.from_numpy(kept[-1][:, 0])], np.asarray(jout)[kept[-1][:, 0]], tol)
    # every cache leaf (KV rings, MLA latents, ssm / conv / lru states), laid
    # out as in JAX; with routing logs, at the positions whose token was
    # routed alike
    jcache = jax.tree.map(np.asarray, jcache)
    if logs is not None:
        keep = np.concatenate(kept, axis=1)             # (B, max_len)
        cache = {"stack": _tree(cache["stack"], lambda t: t[:, torch.from_numpy(keep)]),
                 **({"tail": _tree(cache["tail"], lambda t: t[torch.from_numpy(keep)])}
                    if "tail" in cache else {})}
        jcache = {"stack": _tree(jcache["stack"], lambda t: t[:, keep]),
                  **({"tail": _tree(jcache["tail"], lambda t: t[keep])}
                     if "tail" in jcache else {})}
    walk_close(cache, jcache, tol)
    assert launch_counts() == before          # CPU tensors launch no kernel


def _tree(tree, fn):
    return {k: _tree(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,layers", [("mamba2_780m", 48), ("recurrentgemma_9b", 38)])
def test_decode_vs_fresh_prefill_gap_is_no_larger_than_jax(arch, layers, dtype):
    """The decode-vs-fresh-prefill gap at the full depth and the reduced
    width, one set of weights in both packages: prefill 64 tokens, decode 32
    teacher-forced steps, against one prefill of all 96; the relative L2 gap
    of the last position's logits (printed with -s). In bf16 decode and
    prefill round at different points in the JAX package too, so its gap is
    the yardstick: the port's may not exceed it by more than a factor 3 (the
    drift is a random walk of roundings). In float32 both stay within the
    3e-2 that the card's check holds the port to."""
    jm, jparams, tm, tparams = _models(arch, n_layers=layers, dtype=dtype)
    v, p0, n = tm.cfg.vocab_size, 64, 32
    toks = np.random.default_rng(6).integers(0, v, (1, p0 + n)).astype(np.int32)
    pos = [np.full((1,), p0 + i, np.int32) for i in range(n)]

    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode)
    _, c = jprefill(jparams, jnp.asarray(toks[:, :p0]), jm.init_cache(1, p0 + n))
    for i in range(n):
        jd, c = jdecode(jparams, jnp.asarray(toks[:, p0 + i:p0 + i + 1]), c, jnp.asarray(pos[i]))
    jf, _ = jprefill(jparams, jnp.asarray(toks), jm.init_cache(1, p0 + n))
    with torch.no_grad():
        c = tm.init_cache(1, p0 + n)
        _, c = tm.prefill(tparams, torch.from_numpy(toks[:, :p0]), c)
        for i in range(n):
            td, c = tm.decode(tparams, torch.from_numpy(toks[:, p0 + i:p0 + i + 1]), c,
                              torch.from_numpy(pos[i]))
        tf, _ = tm.prefill(tparams, torch.from_numpy(toks), tm.init_cache(1, p0 + n))

    def gap(d, f):
        d, f = ((a.float().numpy() if isinstance(a, torch.Tensor) else
                 np.asarray(a, np.float32))[0, -1, :v] for a in (d, f))
        return float(np.linalg.norm(d - f) / np.linalg.norm(f))
    gap_t, gap_j = gap(td, tf), gap(jd, jf)
    print(f"{arch} reduced width, {layers} layers, {dtype}: decode vs fresh prefill relative "
          f"L2 gap: port {gap_t:.4e}, JAX package {gap_j:.4e}")
    if dtype == "float32":
        assert max(gap_t, gap_j) < 3e-2
    else:
        assert gap_t <= 3.0 * gap_j


def walk_close(t, j, tol):
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        for key in t:
            walk_close(t[key], j[key], tol)
    else:
        assert tuple(t.shape) == j.shape
        _close(t, j, tol)


@pytest.mark.parametrize("arch,overrides", [("olmoe_1b_7b", {}),
                                            ("deepseek_v2_236b", {"attn_chunk": 16}),
                                            ("qwen3_32b", {})])
def test_lm_loss_matches_jax(arch, overrides):
    """``loss`` = NLL + the MoE layers' aux loss, with its parts, as the JAX
    package's (deepseek: the chunked MLA prefill under the loss)."""
    jm, jparams, tm, tparams = _models(arch, **overrides)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, parts = tm.loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, jparts = jm.loss(jparams, jax.tree.map(jnp.asarray, batch), remat="none")
    _close(loss, jloss, MODEL)
    for key in ("nll", "aux"):
        _close(parts[key], jparts[key], MODEL)
    assert (float(parts["aux"]) > 0) == bool(tm.cfg.n_experts)


def test_non_dense_families_name_their_roadmap_item():
    """Every config of the JAX package runs on the port: ``unsupported()``
    names no ROADMAP item for any of the ten, full or reduced, and the
    encoder-decoder builds as ``EncDecLM``."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import EncDecLM
    from repro_torch.models.transformer import unsupported
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert unsupported(get_config(arch)) is None, arch
        assert unsupported(reduced_config(arch)) is None, arch
    assert isinstance(build_model(reduced_config("whisper_small"), device="cpu"), EncDecLM)
    assert not isinstance(build_model(reduced_config("paligemma_3b"), device="cpu"), EncDecLM)


@pytest.mark.parametrize("prompt,overrides,patches", [
    (16, {}, True),                         # 16 patches + 16 tokens, below attn_chunk
    # above attn_chunk the prefix keeps attention off flash: the query-chunked
    # plain path (16 + 112 = 128 rows, chunks of 16), and one plain pass where
    # the rows are no multiple of the chunk (16 + 105 = 121)
    (112, {"attn_chunk": 64}, True),
    (105, {"attn_chunk": 64}, True),
    # float32 patches into the bf16 model: cast to its dtype, as in JAX
    (16, {"dtype": "bfloat16"}, True),
    # no patches: apply starts from prefix 0, prefill from the config's 16
    (24, {}, False),
])
def test_vlm_prefix_apply_loss_prefill_decode_match_jax(prompt, overrides, patches):
    """PaliGemma's prefix: logits (the patch rows included), the loss (patch
    rows carry none), prefill over patches + prompt, 4 decode steps at
    positions offset by the patches, and every cache leaf (wv at the fan-in
    of d_model: see ``_models``)."""
    B, steps = 2, 4
    jm, jparams, tm, tparams = _models("paligemma_3b", wv_fan_in_d_model=True, **overrides)
    cfg = tm.cfg
    tol = BF16_MODEL if cfg.dtype == "bfloat16" else MODEL
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (B, prompt + steps + 1)).astype(np.int32)
    P = cfg.n_patches if patches else 0
    extra = _arr(rng, B, cfg.n_patches, cfg.d_model, scale=0.5)
    tx = {"extra_embeddings": torch.from_numpy(extra)} if patches else {}
    jx = {"extra_embeddings": jnp.asarray(extra)} if patches else {}

    logits, aux = tm.apply(tparams, torch.from_numpy(toks[:, :prompt]), **tx)
    jlogits, jaux = jm.apply(jparams, jnp.asarray(toks[:, :prompt]), remat="none", **jx)
    assert logits.shape[1] == P + prompt
    _close(logits, jlogits, tol)

    batch = {"tokens": toks[:, :prompt], "labels": toks[:, 1:prompt + 1]}
    loss, parts = tm.loss(tparams, {**{k: torch.from_numpy(v) for k, v in batch.items()}, **tx})
    jloss, jparts = jm.loss(jparams, {**jax.tree.map(jnp.asarray, batch), **jx}, remat="none")
    _close(loss, jloss, tol)
    _close(parts["nll"], jparts["nll"], tol)

    max_len = P + prompt + steps
    before = launch_counts()
    with torch.no_grad():
        out, cache = tm.prefill(tparams, torch.from_numpy(toks[:, :prompt]),
                                tm.init_cache(B, max_len), **tx)
    jout, jcache = jm.prefill(jparams, jnp.asarray(toks[:, :prompt]), jm.init_cache(B, max_len),
                              **jx)
    _close(out, jout, tol)
    jdecode = jax.jit(jm.decode)
    for i in range(steps):
        pos = np.full((B,), P + prompt + i, np.int32)
        tok = toks[:, prompt + i:prompt + i + 1]
        with torch.no_grad():
            out, cache = tm.decode(tparams, torch.from_numpy(tok), cache, torch.from_numpy(pos))
        jout, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        _close(out, jout, tol)
    walk_close(cache, jax.tree.map(np.asarray, jcache), tol)
    assert launch_counts() == before          # CPU tensors launch no kernel


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
