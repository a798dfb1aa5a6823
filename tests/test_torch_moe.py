"""The port's Mixture-of-Experts and multi-head latent attention
(repro_torch.models.mlp / attention / transformer) against the JAX package's.

The same numpy inputs and the same weights (the JAX init, carried across by
``repro_torch.models.convert.from_numpy``) go through both packages.
Tolerances as in ``tests/test_torch_models.py``: float32 2e-5 for single
functions, 1e-4 (``MODEL``) where a layer's f32 sums add up. The capacity
semantics are the function: with the reference's capacity factor of 1.25
and below, tokens are dropped, and the port must drop the same ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as j_reduced
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import from_numpy
from repro_torch.optim.adamw import tree_leaves

from test_torch_models import F32, MODEL, _arr, _close, walk_close

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)


def _cfgs(arch, **overrides):
    return (dataclasses.replace(j_reduced(arch), **overrides),
            dataclasses.replace(reduced_config(arch), **overrides))


def _moe_weights(jcfg, dtype=jnp.float32, seed=1):
    w = jax.tree.map(np.asarray, jmlp.init_moe(jax.random.PRNGKey(seed), jcfg, dtype))
    return jax.tree.map(jnp.asarray, w), from_numpy(w, device="cpu")


def _lossless(cfg):
    """The capacity factor at which no expert can drop a token: C ≥ Tl."""
    return cfg.n_experts / cfg.experts_per_token


# ---------------------------------------------------------------- apply_moe
@pytest.mark.parametrize("arch,overrides,B,S", [
    ("olmoe_1b_7b", dict(capacity_factor=4.0), 2, 16),        # lossless: 8 experts top 2
    ("olmoe_1b_7b", {}, 2, 64),                               # the reference's 1.25: drops
    ("olmoe_1b_7b", dict(capacity_factor=0.05, moe_groups=1), 2, 32),   # C = 2 of 64 tokens
    ("olmoe_1b_7b", dict(moe_groups=1), 2, 24),
    ("olmoe_1b_7b", dict(moe_groups=2), 2, 24),
    ("olmoe_1b_7b", dict(moe_groups=4), 2, 24),
    ("olmoe_1b_7b", {}, 1, 7),                                # 7 tokens: one group
    ("deepseek_v2_236b", {}, 2, 32),                          # shared experts, 1.25
    ("deepseek_v2_236b", dict(capacity_factor=4.0, moe_groups=2), 3, 8),
])
def test_apply_moe_matches_jax(arch, overrides, B, S):
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp, tp = _moe_weights(jcfg)
    x = _arr(np.random.default_rng(11), B, S, jcfg.d_model)
    out, aux = tmlp.apply_moe(tp, torch.from_numpy(x), tcfg)
    jout, jaux = jax.jit(jmlp.apply_moe, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    _close(out, jout, MODEL)
    _close(aux, jaux, MODEL)
    assert out.dtype == torch.float32 and aux.shape == ()


def test_reference_capacity_drops_and_the_port_drops_the_same():
    """At 1.25 some (token, slot)s lose their expert: the dropped set and
    every destination row equal the reference's ranking."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b")
    jp, tp = _moe_weights(jcfg)
    x = _arr(np.random.default_rng(12), 2, 64, jcfg.d_model)
    G = tmlp.dispatch_groups(128, tcfg)
    xg = torch.from_numpy(x).reshape(G, 128 // G, -1)
    r = tmlp.route(tp, xg, tcfg)
    E, C = tcfg.n_experts, r.capacity
    dropped = int((r.dest == E * C).sum())
    assert 0 < dropped < r.dest.numel()

    # the reference's ranking, from its own routing ops on the same input
    def jdest(p, xg):
        logits = jnp.einsum("gtd,de->gte", xg, p["router"]).astype(jnp.float32)
        _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.experts_per_token)
        flat = eidx.reshape(G, -1)
        order = jnp.argsort(flat, axis=-1, stable=True)
        se = jnp.take_along_axis(flat, order, axis=-1)
        starts = jax.vmap(lambda s: jnp.searchsorted(s, jnp.arange(E, dtype=s.dtype)))(se)
        rank = jnp.arange(flat.shape[1])[None] - jnp.take_along_axis(starts, se, axis=-1)
        ds = jnp.where(rank < C, se * C + rank, E * C)
        return jnp.take_along_axis(ds, jnp.argsort(order, axis=-1), axis=-1).reshape(eidx.shape)
    np.testing.assert_array_equal(r.dest.numpy(), np.asarray(jdest(jp, jnp.asarray(
        xg.numpy()))))


def test_top_k_breaks_ties_by_the_lower_index_as_jax():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15], [0.2] * 5], np.float32)
    vals, idx = tmlp._top_k(torch.from_numpy(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_apply_moe_in_bfloat16_matches_jax_on_the_tokens_routed_alike(arch):
    """bf16, lossless capacity: the router product is rounded to bf16 before
    the softmax, so a routing decision can flip on a near-tie between the two
    packages. Every (token, slot) whose expert differs must be a near-tie:
    its probability within bf16 resolution of the k-th largest (the
    reference's) and of the one that replaced it. The outputs are compared on
    the tokens routed alike, at the bf16 block tolerance."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=_lossless(tcfg))
    jcfg = dataclasses.replace(jcfg, capacity_factor=_lossless(jcfg))
    jp, tp = _moe_weights(jcfg, jnp.bfloat16)
    B, S, K = 4, 64, jcfg.experts_per_token
    x = _arr(np.random.default_rng(13), B, S, jcfg.d_model)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    out, aux = tmlp.apply_moe(tp, xt, tcfg)
    jout, jaux = jax.jit(jmlp.apply_moe, static_argnums=2)(jp, xj, jcfg)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16

    # each package's top-k of its own bf16 router product
    jprobs = jax.nn.softmax(jnp.einsum("btd,de->bte", xj, jp["router"].astype(xj.dtype))
                            .astype(jnp.float32), axis=-1)
    jidx = np.asarray(jax.lax.top_k(jprobs, K)[1])
    tprobs = torch.softmax(torch.einsum("btd,de->bte", xt, tp["router"].to(xt.dtype)).float(),
                           dim=-1)
    tidx = tmlp._top_k(tprobs, K)[1].numpy()
    jp_np = np.asarray(jprobs)
    kth = np.sort(jp_np, axis=-1)[..., -K]                   # the k-th largest, per token
    res = 2.0 ** -7
    for b, t, k in zip(*np.nonzero(np.sort(jidx, -1) != np.sort(tidx, -1))):
        gone = set(jidx[b, t]) - set(tidx[b, t])
        came = set(tidx[b, t]) - set(jidx[b, t])
        for e in gone | came:
            gap = abs(jp_np[b, t, e] - kth[b, t])
            assert gap <= res * kth[b, t], (b, t, e, gap, kth[b, t])
    alike = np.all(np.sort(jidx, -1) == np.sort(tidx, -1), axis=-1)   # (B, S)
    assert alike.mean() > 0.9
    a = out.float().numpy()[alike]
    j = np.asarray(jout, np.float32)[alike]
    assert np.linalg.norm(a - j) / np.linalg.norm(j) <= 2e-2
    _close(aux, jnp.asarray(jaux), dict(atol=1e-3, rtol=2e-2))


@pytest.mark.parametrize("n_tokens", [1, 4, 7, 32, 48, 96, 128, 4096, 4097, 16384])
def test_dispatch_groups_and_capacity_match_jax(n_tokens):
    for arch in ("olmoe_1b_7b", "deepseek_v2_236b"):
        for reduced in (True, False):
            jcfg = j_reduced(arch) if reduced else jget_config(arch)
            tcfg = reduced_config(arch) if reduced else get_config(arch)
            g = tmlp.dispatch_groups(n_tokens, tcfg)
            assert g == jmlp.dispatch_groups(n_tokens, jcfg)
            assert tmlp.moe_capacity(tcfg, n_tokens // g) == \
                jmlp.moe_capacity(jcfg, n_tokens // g)


# ---------------------------------------------------------------- MLA
def _mla_inputs(seed, B, S, T, jcfg):
    rng = np.random.default_rng(seed)
    w = jax.tree.map(np.asarray, jtransformer.init_mla(jax.random.PRNGKey(seed), jcfg,
                                                       jnp.float32))
    names = ("wq_nope", "wq_rope", "wk_nope", "wv")
    cq = _arr(rng, B, S, jcfg.q_lora_rank)
    ckv = _arr(rng, B, T, jcfg.kv_lora_rank)
    kr = _arr(rng, B, T, jcfg.qk_rope_dim)
    return cq, ckv, kr, [np.array(w[n]) for n in names]


@pytest.mark.parametrize("S,q_chunk,causal", [(24, None, True), (64, 16, True),
                                              (64, 16, False), (40, 16, True)])
def test_mla_prefill_matches_jax(S, q_chunk, causal):
    """The whole-sequence path, the query-chunked path (S = 64 in chunks of
    16) and a chunk that does not divide S (40: the whole path)."""
    jcfg, _ = _cfgs("deepseek_v2_236b")
    cq, ckv, kr, ws = _mla_inputs(14, 2, S, S, jcfg)
    kw = dict(rope_theta=jcfg.rope_theta, causal=causal, q_chunk=q_chunk)
    out = tattn.mla_prefill(*map(torch.from_numpy, [cq, ckv, kr] + ws), **kw)
    jout = jattn.mla_prefill(*map(jnp.asarray, [cq, ckv, kr] + ws), **kw)
    assert tuple(out.shape) == (2, S, jcfg.n_heads, jcfg.v_head_dim)
    _close(out, jout, F32)


def test_mla_prefill_chunked_gradients_match_the_whole_path():
    """Each chunk is recomputed in the backward (checkpoint): the gradients
    equal the whole path's."""
    jcfg, _ = _cfgs("deepseek_v2_236b")
    cq, ckv, kr, ws = _mla_inputs(15, 1, 32, 32, jcfg)

    def grads(q_chunk):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in [cq, ckv, kr] + ws]
        out = tattn.mla_prefill(*xs, rope_theta=jcfg.rope_theta, q_chunk=q_chunk)
        return torch.autograd.grad(out.square().sum(), xs)
    for a, b in zip(grads(8), grads(None)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_mla_decode_matches_jax():
    jcfg, _ = _cfgs("deepseek_v2_236b")
    cq, ckv, kr, ws = _mla_inputs(16, 3, 1, 24, jcfg)
    lens = np.array([1, 13, 24], np.int32)
    kw = dict(rope_theta=jcfg.rope_theta)
    out = tattn.mla_decode(torch.from_numpy(cq), torch.from_numpy(ckv), torch.from_numpy(kr),
                           torch.from_numpy(lens), *map(torch.from_numpy, ws), **kw)
    jout = jattn.mla_decode(jnp.asarray(cq), jnp.asarray(ckv), jnp.asarray(kr),
                            jnp.asarray(lens), *map(jnp.asarray, ws), **kw)
    assert tuple(out.shape) == (3, 1, jcfg.n_heads, jcfg.v_head_dim)
    _close(out, jout, F32)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_mla_block_matches_jax(mode):
    jcfg, tcfg = _cfgs("deepseek_v2_236b")
    w = jax.tree.map(np.asarray, jtransformer.init_mla(jax.random.PRNGKey(2), jcfg,
                                                       jnp.float32))
    rng = np.random.default_rng(17)
    B, T = 2, 20
    S = 1 if mode == "decode" else 12
    x = _arr(rng, B, S, jcfg.d_model)
    cache = {"ckv": _arr(rng, B, T, jcfg.kv_lora_rank),
             "krope": _arr(rng, B, T, jcfg.qk_rope_dim)}
    pos = np.full((B,), 15, np.int32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    out = ttransformer.apply_mla_block(from_numpy(w, device="cpu"), torch.from_numpy(x), tcfg,
                                       mode=mode, cache=tcache, pos=torch.from_numpy(pos))
    jout, jnew = jtransformer.apply_mla_block(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x), jcfg, mode=mode,
        cache={k: jnp.asarray(v) for k, v in cache.items()}, pos=jnp.asarray(pos))
    _close(out, jout, F32)
    if mode != "train":
        walk_close(tcache, jax.tree.map(np.asarray, jnew), F32)


# ---------------------------------------------------------------- layouts
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_init_moe_and_init_mla_lay_out_like_jax(arch):
    """Shapes and dtypes of ``init_moe`` / ``init_mla`` (and with a stacking
    ``lead``) equal the JAX package's; the router stays float32."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    pairs = [(tmlp.init_moe(gen, tcfg, torch.bfloat16),
              jmlp.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))]
    if tcfg.mla:
        pairs.append((ttransformer.init_mla(gen, tcfg, torch.bfloat16),
                      jtransformer.init_mla(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)))
    for t, j in pairs:
        flat_j, flat_t = _flat_jax(j), _flat(t)
        assert flat_t.keys() == flat_j.keys()
        for k, leaf in flat_t.items():
            assert tuple(leaf.shape) == flat_j[k].shape, k
            assert str(leaf.dtype).removeprefix("torch.") == str(flat_j[k].dtype), k
    stacked = tmlp.init_moe(gen, tcfg, torch.bfloat16, lead=(3,))
    assert stacked["w_up"].shape == (3,) + tuple(pairs[0][0]["w_up"].shape)
    assert stacked["router"].dtype == torch.float32


def _flat(tree, prefix=""):
    """path -> leaf of a port tree."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _flat_jax(tree):
    """path -> leaf of a JAX tree."""
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_models_lay_out_params_and_caches_like_jax(arch):
    """The whole model's parameter and cache trees: the stacked MoE units,
    DeepSeek's dense-first tail, the MLA latent caches."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jtransformer.LM(jcfg), ttransformer.LM(tcfg, device="cpu")
    assert tm.layer_kinds() == jm.layer_kinds()
    assert tm.scan_groups() == jm.scan_groups()
    for t, j in ((tm.init(torch.Generator().manual_seed(0)),
                  jax.eval_shape(jm.init, jax.random.PRNGKey(0))),
                 (tm.init_cache(2, 40), jax.eval_shape(lambda: jm.init_cache(2, 40)))):
        flat_j, flat_t = _flat_jax(j), _flat(t)
        assert flat_t.keys() == flat_j.keys()
        for k, leaf in flat_t.items():
            assert tuple(leaf.shape) == flat_j[k].shape, k


def test_tail_runs_first_in_deepseek_and_last_elsewhere():
    ds = ttransformer.LM(reduced_config("deepseek_v2_236b"), device="cpu")
    params = ds.init(torch.Generator().manual_seed(0))
    kinds = [kind for kind, _, _ in ds._layers(params)]
    assert kinds == ["dense_mlp", "moe", "moe"] and ds.tail_first
    rg = ttransformer.LM(reduced_config("recurrentgemma_9b"), device="cpu")
    kinds = [kind for kind, _, _ in rg._layers(rg.init(torch.Generator().manual_seed(0)))]
    assert kinds == list(rg.layer_kinds()) and not rg.tail_first


# ---------------------------------------------------------------- gradients
def _jleaves(t, j):
    """The leaves of the JAX tree ``j`` in the port tree ``t``'s key order."""
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        return [x for k in t for x in _jleaves(t[k], j[k])]
    assert tuple(t.shape) == j.shape
    return [j]


def _grad_close(t, j):
    """A gradient within 2e-5 of its leaf's largest magnitude (float32 sums
    in another order), as ``tests/test_torch_train.py`` holds the LM's."""
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=2e-5 * max(float(np.abs(j).max()), 1e-30))


@pytest.mark.parametrize("arch,overrides,B,S", [
    ("olmoe_1b_7b", dict(capacity_factor=4.0), 2, 16),        # lossless
    ("olmoe_1b_7b", {}, 2, 64),                               # 1.25: slots drop
    ("olmoe_1b_7b", dict(capacity_factor=0.05, moe_groups=1), 2, 32),   # most slots drop
    ("deepseek_v2_236b", {}, 2, 32),                          # shared experts
])
@pytest.mark.parametrize("part", ["out", "aux"])
def test_apply_moe_gradients_match_jax(arch, overrides, B, S, part):
    """jax.grad against autograd through the dispatch, for every weight and
    the input: the scatter into the trash-row buffer (a dropped slot's input
    gets no gradient, as JAX's ``.at[d].set(..., mode="drop")`` gives it
    none), the combine's gathers (dropped slots read row 0 weighted by 0, so
    row 0's gradient gains only zeros), the gates through the stable top-k,
    and the aux loss alone (through the mean probabilities; the top-1
    one-hot carries none)."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp, tp = _moe_weights(jcfg)
    rng = np.random.default_rng(21)
    x = _arr(rng, B, S, jcfg.d_model)
    r = _arr(rng, B, S, jcfg.d_model)

    def jloss(p, x):
        out, aux = jmlp.apply_moe(p, x, jcfg)
        return jnp.sum(out * r) if part == "out" else aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))

    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmlp.apply_moe(tp, tx, tcfg)
    loss = torch.sum(out * torch.from_numpy(r)) if part == "out" else aux
    grads = torch.autograd.grad(loss, leaves + [tx], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves + [tx])]
    jleaves = _jleaves(tp, jax.tree.map(np.asarray, jgp))
    assert len(jleaves) == len(leaves)
    for g, j in zip(grads[:-1], jleaves):
        _grad_close(g, j)
    _grad_close(grads[-1], jgx)
    if part == "aux":      # only the router feeds the aux loss
        assert all(float(g.abs().max()) == 0 for g, t in zip(grads[:-1], leaves)
                   if t is not tp["router"])


def test_dropped_slots_get_no_input_gradient():
    """With the router at zero (uniform probabilities: every token picks
    experts 0 and 1 by the tie order, and a capacity of 2 keeps the first
    tokens), a token whose slots all dropped gets no input gradient at all
    (no expert path, and the zero router passes none), the kept tokens do."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b", capacity_factor=0.05, moe_groups=1)
    _, tp = _moe_weights(jcfg)
    tp = {k: (torch.zeros_like(v) if k == "router" else v) for k, v in tp.items()}
    x = torch.from_numpy(_arr(np.random.default_rng(22), 1, 32, jcfg.d_model))
    x.requires_grad_(True)
    r = tmlp.route(tp, x.detach().reshape(1, 32, -1), tcfg)
    dead = (r.dest == tcfg.n_experts * r.capacity).all(-1)[0]
    assert bool(dead.any()) and not bool(dead.all())
    out, _ = tmlp.apply_moe(tp, x, tcfg)
    g, = torch.autograd.grad(out.sum(), [x])
    assert float(g[0, dead].abs().max()) == 0.0
    assert float(g[0, ~dead].abs().max()) > 0.0


def test_mla_prefill_chunked_gradients_match_jax():
    """jax.grad through the reference's remat'd query chunks against
    autograd through the port's checkpointed chunks (S = 32 in chunks of 8),
    for every input and weight."""
    jcfg, _ = _cfgs("deepseek_v2_236b")
    cq, ckv, kr, ws = _mla_inputs(23, 2, 32, 32, jcfg)
    r = _arr(np.random.default_rng(24), 2, 32, jcfg.n_heads, jcfg.v_head_dim)
    kw = dict(rope_theta=jcfg.rope_theta, q_chunk=8)

    def jloss(*xs):
        return jnp.sum(jattn.mla_prefill(*xs, **kw) * r)
    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(*map(jnp.asarray, [cq, ckv, kr] + ws))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in [cq, ckv, kr] + ws]
    loss = torch.sum(tattn.mla_prefill(*xs, **kw) * torch.from_numpy(r))
    for a, b in zip(torch.autograd.grad(loss, xs), jg):
        _grad_close(a, b)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_remat_recompute_routes_as_the_forward(arch, monkeypatch):
    """Under remat="full" every stacked unit's recompute routes its tokens
    exactly as its first forward did: the same experts, gates and
    destination rows, in reverse unit order, with nothing read on the host."""
    tcfg = reduced_config(arch)
    model = ttransformer.LM(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    seen = []
    route = tmlp.route

    def logged(p, xg, cfg):
        r = route(p, xg, cfg)
        seen.append(tuple(t.detach().clone() for t in (r.experts, r.gate, r.dest)))
        return r
    monkeypatch.setattr(tmlp, "route", logged)
    toks = torch.randint(0, tcfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(4))
    loss, _ = model.loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, remat="full")
    n_fwd = len(seen)
    _, n_units, _ = model.scan_groups()
    assert n_fwd == n_units
    torch.autograd.grad(loss, leaves)
    assert len(seen) == 2 * n_fwd
    for first, again in zip(seen[:n_fwd], reversed(seen[n_fwd:])):
        for a, b in zip(first, again):
            assert torch.equal(a, b)
