"""The port served under a ("data", "model") mesh on 4 gloo CPU ranks, against
the JAX package's sharded serving and the port's own plain serving.

Each reduced arch (qwen3_32b, h2o_danube_1_8b with its 32-token window and a
prompt of 40, so the ring cache is rolled at prefill and wraps again at
decode, mamba2_780m, recurrentgemma_9b, olmoe_1b_7b, deepseek_v2_236b,
whisper_small with its frames and paligemma_3b with its patches, both in the
model's dtype), from the JAX package's init (numpy; the GQA projections at
the fan-in of d_model, see ``_fan_in_d_model``), a prompt of (4, 16) tokens,
prefill and 4 greedy decode steps through ``launch.serve.generate``: the
parameters laid out by ``param_specs``, the cache (paligemma's sized with its
patches: ``n_patches + S + G``) by ``cache_specs``, the prompt, each step's
``pos`` and the stubs by ``batch_specs``, as ``serve_structs`` lays them
out. Then:

* on a (2, 2) mesh, against the JAX package's jitted prefill and decode on a
  (2, 2) mesh of 4 forced host devices laid out alike
  (``tests/torch_mesh_serve_jax.py``, one subprocess beside the ranks):
  every step's logits within 1e-5 of each row's largest magnitude, the
  greedy tokens equal, every cache leaf laid out as JAX lays it out;
* at batch 1 on (2, 2) (qwen3 and deepseek's MLA latents), where
  ``cache_specs`` shards the sequence over both axes: the same;
* on a (1, 4) mesh, against the port's plain serving in this process: the
  logits within 1e-5 of each row's max, the tokens equal;
* every decode step's attention takes the DTensor decode entry's
  ``"sharded_keys"`` branch (GQA, MLA's latents and whisper's
  cross-attention), once a layer a step, and never ``"replicate"``
  (``ops.decode_branch``).

``decode_attention_partial_ref`` merged over 1 to 4 shards by log-sum-exp
against ``decode_attention_ref``; and the serve launcher on 2 gloo ranks
against the launcher without a group.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (NEG_INF, decode_attention_partial_ref,
                                                  decode_attention_ref)
from repro_torch.launch import serve
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402  (the ranks' functions, importable by spawned processes)

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
TIMEOUT = 420
ARCHS = ("qwen3_32b", "h2o_danube_1_8b", "mamba2_780m", "recurrentgemma_9b", "olmoe_1b_7b",
         "deepseek_v2_236b", "whisper_small", "paligemma_3b")
BATCH_ONE = ("qwen3_32b", "deepseek_v2_236b")
B, S, GEN = 4, 16, 4
PROMPT = {"h2o_danube_1_8b": 40}      # above the 32-token window: the ring rolls and wraps
MESHES = ((2, 2), (1, 4))
TOL = 1e-5


def _fan_in_d_model(params):
    """Every GQA projection (d_model, heads, head_dim) (wq, wk, wv) at the
    fan-in of d_model: the reference init reads it from the heads, which
    makes attention a hard max (std 1 for an MQA model's wv), and at that
    init a 1e-7 nudge of the embedding moves recurrentgemma's reduced
    logits by 2e-5 of their max, past the tolerance of two float32 orders
    of summation."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("wq", "wk", "wv"):
                d, h = v.shape[-3], v.shape[-2]
                tree[k] = (v * np.float32((h / d) ** 0.5)).astype(v.dtype)
    walk(params)
    return params


def _case(arch, batch):
    """The JAX init (numpy), a prompt and the frontend stubs in the model's
    dtype."""
    cfg = j_reduced(arch)
    params = jax.tree.map(np.asarray, jax.jit(j_build_model(cfg).init)(jax.random.PRNGKey(0)))
    if not cfg.mla:
        params = _fan_in_d_model(params)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (batch, PROMPT.get(arch, S))).astype(np.int32)
    dt = np.float32 if cfg.dtype == "float32" else None
    stubs = {}
    if cfg.encdec:
        stubs["encoder_frames"] = (rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
                                   * 0.02).astype(dt)
    if cfg.vision_stub:
        stubs["extra_embeddings"] = (rng.standard_normal((batch, cfg.n_patches, cfg.d_model))
                                     * 0.02).astype(dt)
    return dict(params=params, tokens=tokens, stubs=stubs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    cases = {(arch, B): _case(arch, B) for arch in ARCHS}
    cases.update({(arch, 1): _case(arch, 1) for arch in BATCH_ONE})
    jax_cases = [((arch, b), arch, (2, 2), c["params"], c["tokens"], c["stubs"], GEN)
                 for (arch, b), c in cases.items()]
    inp, out = tmp / "jax_in.pkl", tmp / "jax_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(jax_cases, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_serve_jax.py"),
                                 str(inp), str(out)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        keys = [(arch, B, shape) for shape in MESHES for arch in ARCHS]
        keys += [(arch, 1, (2, 2)) for arch in BATCH_ONE]
        rank_cases = [(arch, (), shape, cases[(arch, b)]["params"], cases[(arch, b)]["tokens"],
                       cases[(arch, b)]["stubs"], GEN) for arch, b, shape in keys]
        ranks = run_ranks(torch_mesh_ranks.serve_rank, 4, (rank_cases,), backend="gloo",
                          timeout=TIMEOUT)
        stdout, stderr = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0 and "TORCH_MESH_SERVE_JAX_OK" in stdout, stdout + stderr
    with open(out, "rb") as f:
        jax_out = pickle.load(f)
    port = {key: [rk[i] for rk in ranks] for i, key in enumerate(keys)}
    return dict(cases=cases, jax=jax_out, port=port)


def _within_row_max(got, exp, tol=TOL):
    """Every logit within ``tol`` of its row's largest magnitude."""
    got, exp = torch.as_tensor(got), torch.as_tensor(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype
    err = (got - exp).abs().amax(dim=-1) / exp.abs().amax(dim=-1)
    assert float(err.max()) <= tol, float(err.max())


def _axes_by_dim(placements, names=("data", "model")):
    """tensor dim -> the mesh axes that shard it, of a cache leaf's DTensor
    placements (as ``tests/torch_mesh_serve_jax.py`` reads JAX's specs)."""
    dims = {}
    for name, p in zip(names, placements):
        if p.startswith("S("):
            dims.setdefault(int(p[2:-1]), []).append(name)
    return dims


def _check_against_jax(runs, arch, b):
    exp = runs["jax"][(arch, b)]
    assert all(np.all(np.isfinite(x)) for x in exp["logits"])
    for got in runs["port"][(arch, b, (2, 2))]:
        assert len(got["logits"]) == GEN + 1
        for a, e in zip(got["logits"], exp["logits"]):
            _within_row_max(a, torch.from_numpy(e))
        np.testing.assert_array_equal(got["tokens"].numpy(), exp["tokens"])
        for path, pl in got["placements"].items():
            assert _axes_by_dim(pl) == exp["specs"][path.lstrip("/")], (path, pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_mesh_serving_matches_jax_sharded_serving(runs, arch):
    _check_against_jax(runs, arch, B)
    # the attention caches' sequence over "model" (stacked: dim 2), the batch over "data"
    for got in runs["port"][(arch, B, (2, 2))]:
        for path, pl in got["placements"].items():
            name = path.split("/")[-1]
            stacked = path.startswith(("/stack", "/self", "/cross"))
            if name in ("k", "v", "ckv", "krope"):
                assert pl == [f"S({int(stacked)})", f"S({1 + int(stacked)})"], (path, pl)


@pytest.mark.parametrize("arch", BATCH_ONE)
def test_batch_one_on_2x2_shards_the_sequence_over_both_axes(runs, arch):
    _check_against_jax(runs, arch, 1)
    for got in runs["port"][(arch, 1, (2, 2))]:
        leaves = [(path, pl) for path, pl in got["placements"].items()
                  if path.split("/")[-1] in ("k", "v", "ckv", "krope")]
        assert leaves
        for path, pl in leaves:          # stacked (L, 1, T, ...): dim 2; the tail's: dim 1
            t = 2 if path.startswith("/stack") else 1
            assert pl == [f"S({t})", f"S({t})"], (path, pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_1x4_mesh_serving_matches_plain_serving(runs, arch):
    c = runs["cases"][(arch, B)]
    cfg = reduced_config(arch)
    exp = generate(build_model(cfg, device="cpu"), from_numpy(c["params"], device="cpu"),
                   torch.from_numpy(c["tokens"]),
                   {k: torch.from_numpy(v) for k, v in c["stubs"].items()}, GEN, keep_logits=True)
    for got in runs["port"][(arch, B, (1, 4))]:
        for a, e in zip(got["logits"], exp["logits"]):
            _within_row_max(a, e)
        assert torch.equal(got["tokens"], exp["tokens"])


def _attention_layers(arch) -> int:
    """The layers whose decode attends over a cache: GQA and MLA layers, and
    an encoder-decoder's self- and cross-attention."""
    cfg = reduced_config(arch)
    if cfg.encdec:
        return 2 * cfg.n_layers
    kinds = build_model(cfg, device="cpu").layer_kinds()
    return sum(k not in ("ssm", "rec") for k in kinds)


@pytest.mark.parametrize("shape", MESHES)
def test_every_decode_step_takes_the_sharded_keys_branch(runs, shape):
    for arch in ARCHS:
        for got in runs["port"][(arch, B, shape)]:
            assert got["branches"]["replicate"] == 0, (arch, got["branches"])
            assert got["branches"]["sharded_keys"] == GEN * _attention_layers(arch), \
                (arch, got["branches"])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [None, 9])
def test_partial_ref_merged_over_shards_matches_decode_ref(n_shards, window):
    """Shards of a (4, 37) cache (uneven where 37 does not divide), rows of
    lengths 37, 20, 1 and 0, so that shards hold no live key (before the
    length, or below the window); merged by ``ops.merge_partials``' rule on
    one process against the whole cache, float32 within 2e-5."""
    gen = torch.Generator().manual_seed(n_shards)
    Bk, T, H, KV, d = 4, 37, 8, 2, 16
    q = torch.randn(Bk, 1, H, d, generator=gen)
    k, v = (torch.randn(Bk, T, KV, d, generator=gen) for _ in range(2))
    lens = torch.tensor([37, 20, 1, 0])
    exp = decode_attention_ref(q, k, v, lens, window=window)
    exp[lens == 0] = 0.0
    cuts = [round(i * T / n_shards) for i in range(n_shards + 1)]
    parts = [decode_attention_partial_ref(q, k[:, a:b], v[:, a:b], lens, kv_offset=a,
                                          window=window) for a, b in zip(cuts, cuts[1:])]
    o, lse = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    assert bool((lse[:, 3] == NEG_INF).all()) and bool((o[:, 3] == 0).all())
    if n_shards > 1:
        assert bool((lse[1:, 2] == NEG_INF).all())    # row 2's one key lies in shard 0
    m = lse.amax(dim=0)
    w = torch.where(lse > NEG_INF, torch.exp(lse - m), 0.0)[..., None]
    num, den = (w * o.reshape(n_shards, Bk, H, d)).sum(0), w.sum(0)
    got = torch.where(den > 0, num / den.clamp(min=1e-30), 0.0).reshape(Bk, 1, H, d)
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)
    lse_all = torch.logsumexp(torch.where(lse > NEG_INF, lse, -torch.inf), dim=0)
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            continue
        keys = torch.arange(T)
        live = (keys < n) & ((keys > n - 1 - window) if window is not None else True)
        s = torch.einsum("hd,tkd->hkt", q[b, 0], k[b]).reshape(KV, H // KV, KV, T)
        logits = torch.stack([s[g // (H // KV), g % (H // KV), g // (H // KV)]
                              for g in range(H)]) * d ** -0.5
        ref = torch.logsumexp(logits[:, live], dim=-1)
        torch.testing.assert_close(lse_all[b], ref, atol=2e-5, rtol=2e-5)


def test_merge_partials_of_one_partial_is_the_partial():
    """No mesh dim to merge over (a (1, 1) mesh): the output comes back bit
    for bit, 0 where the partial holds no live key."""
    gen = torch.Generator().manual_seed(0)
    o = torch.randn(3, 1, 4, 8, generator=gen)
    lse = torch.randn(3, 1, 4, generator=gen)
    lse[1] = NEG_INF
    o[1] = 0.0
    assert torch.equal(ops.merge_partials(o, lse, None, ()), o)


def test_serve_launcher_on_two_gloo_ranks_matches_no_group():
    argv = ["--arch", "qwen3_32b", "--reduced", "--device", "cpu", "--prompt-len", "16",
            "--gen-len", "6"]
    alone = serve.main(argv)
    assert alone["mesh"] is None
    for out in run_ranks(torch_mesh_ranks.serve_launcher_rank, 2, (argv,), backend="gloo",
                         timeout=TIMEOUT):
        assert out["mesh"] == (1, 2)
        np.testing.assert_array_equal(out["last_token"].numpy(), alone["last_token"])


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_9b"])
def test_recurrent_archs_train_under_a_mesh(arch):
    """mamba2's and recurrentgemma's train steps under a (1, 2) mesh of 2 gloo
    ranks against the plain step (2 steps, remat "none"): their blocks gather
    the sequence before the causal convolution, and the scans run on each
    rank's rows (``ops.ssd_scan`` / ``ops.rglru_scan``); loss and grad norm
    within 1e-5 relative."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_map
    cfg = reduced_config(arch)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.block_pattern:
        params = from_numpy(_fan_in_d_model(tree_map(lambda t: t.numpy(), params)), device="cpu")
    state = tree_map(lambda t: t.numpy(), {"params": params, "opt": adamw_init(params)})
    rng = np.random.default_rng(2)
    blocks = [rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32) for _ in range(2)]
    _, train_step = make_train_step(cfg, remat="none", device="cpu")
    p, o = from_numpy(state["params"], device="cpu"), from_numpy(state["opt"], device="cpu")
    exp = []
    for i, block in enumerate(blocks):
        t = torch.from_numpy(block)
        p, o, m = train_step(p, o, {"tokens": t[:, :-1], "labels": t[:, 1:]}, i)
        exp.append((float(m["loss"]), float(m["grad_norm"])))
    for rk in run_ranks(torch_mesh_ranks.arch_steps_rank, 2,
                        ([(arch, (1, 2), state, blocks, {})],), backend="gloo",
                        timeout=TIMEOUT):
        got = rk[0]
        np.testing.assert_allclose(got["loss"], [e[0] for e in exp], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norm"], [e[1] for e in exp], rtol=1e-5, atol=0)
