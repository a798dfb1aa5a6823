"""The port's MoE, MLA, encoder-decoder and VLM models trained under a
("data", "model") mesh on 4 gloo CPU ranks, against the JAX package's
sharded steps and the port's own plain step.

The reduced olmoe_1b_7b, deepseek_v2_236b, whisper_small and paligemma_3b,
each from the JAX package's init (numpy, ``models/convert.from_numpy``) and
one batch of (4, 16) tokens a step (whisper with 32 encoder frames,
paligemma with 16 patch embeddings, N(0, 0.02^2)), 2 train steps (remat
"none", the state carried):

* on a (2, 2) mesh against the JAX package's jitted steps on a (2, 2) mesh
  of 4 forced host devices (``tests/torch_mesh_archs_jax.py``, one
  subprocess for all four archs, run beside the ranks): loss, nll and aux
  within 1e-4 relative;
* on a (1, 4) mesh against the port's plain step in this process: loss, nll,
  aux and grad norm within 1e-5 relative, the state after the steps within
  1e-5 relative (1e-6 absolute) elementwise;
* every rank holds E / 4 (on (1, 4)) and E / 2 (on (2, 2)) rows of each
  expert leaf, as JAX's shards do.

``apply_moe`` of one layer on (1, 4) and (2, 2) meshes against the plain
call: the routing's rows (the same slots dropped), bit for bit; the output
and the gradients of the input and of every weight within 1e-5 of their
largest magnitude, the aux loss within 1e-5 relative; at the lossless
capacity (E / K), the reference's 1.25, a tiny one (C = K) and with
deepseek's shared expert.

All ranks' work is one ``run_ranks`` call.
"""
import dataclasses
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
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, mlp
from repro_torch.models.convert import from_numpy
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402  (the ranks' functions, importable by spawned processes)

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
TIMEOUT = 420
ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b", "whisper_small", "paligemma_3b")
B, S = 4, 16
STEPS = 2
# 4 dispatch groups of 16 tokens (2 a rank over "data" on (2, 2))
MOE_CASES = [("olmoe_1b_7b", {"capacity_factor": 4.0, "moe_groups": 4}),   # lossless: E / K
             ("olmoe_1b_7b", {"moe_groups": 4}),                           # the reference's 1.25
             ("olmoe_1b_7b", {"capacity_factor": 0.1, "moe_groups": 4}),  # C = K
             ("deepseek_v2_236b", {"moe_groups": 4})]                      # a shared expert
MESHES = ((1, 4), (2, 2))


def _fan_in_d_model(params):
    """The JAX init with every GQA projection of shape (d_model, heads,
    head_dim) (wq, wk, wv) at the fan-in of d_model: the reference init reads
    it from the heads (std 1 for paligemma's one KV head), and at that init a
    1e-7 nudge of the embedding moves whisper's gradients by 1e-3 and
    paligemma's by 2e-4 of their leaves' max, far past any tolerance of two
    float32 orders of summation."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("wq", "wk", "wv"):
                d, h = v.shape[-3], v.shape[-2]
                tree[k] = (v * np.float32((h / d) ** 0.5)).astype(v.dtype)
    walk(params)
    return params


def _case(arch):
    """The JAX init (numpy; GQA projections at the fan-in of d_model), the
    token blocks and the frontend stubs."""
    cfg = j_reduced(arch)
    params = jax.tree.map(np.asarray, jax.jit(j_build_model(cfg).init)(jax.random.PRNGKey(0)))
    if not cfg.mla:
        params = _fan_in_d_model(params)
    rng = np.random.default_rng(1)
    blocks = [rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    stubs = {}
    if cfg.encdec:
        stubs["encoder_frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                                   * 0.02).astype(np.float32)
    if cfg.vision_stub:
        stubs["extra_embeddings"] = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                                     * 0.02).astype(np.float32)
    return dict(params=params, blocks=blocks, stubs=stubs)


def _state_np(params):
    return {"params": params, "opt": {"m": jax.tree.map(np.zeros_like, params),
                                      "v": jax.tree.map(np.zeros_like, params),
                                      "count": np.zeros((), np.int32)}}


def _moe_case(arch, overrides, seed):
    """One MoE layer's weights (the port's init, numpy), x and r."""
    cfg = dataclasses.replace(reduced_config(arch), **overrides)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    moe = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
           for k, v in params["stack"]["u0"]["moe"].items()}
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    r = torch.randn((B, S, cfg.d_model), generator=gen)
    return cfg, moe, x, r


def _numpy(tree):
    """``tree``'s tensors as numpy, in the tree's key order."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_archs")
    cases = {arch: _case(arch) for arch in ARCHS}
    inp, out = tmp / "jax_in.pkl", tmp / "jax_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_archs_jax.py"),
                                 str(inp), str(out)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        step_cases = [(arch, shape, _state_np(c["params"]), c["blocks"], c["stubs"])
                      for shape in MESHES for arch, c in cases.items()]
        moe = [_moe_case(arch, ov, seed) for seed, (arch, ov) in enumerate(MOE_CASES)]
        moe_cases = [(arch, ov, shape, _numpy(p), x, r)
                     for shape in MESHES for (arch, ov), (_, p, x, r) in zip(MOE_CASES, moe)]
        ranks = run_ranks(torch_mesh_ranks.mesh_archs_rank, 4, (step_cases, moe_cases),
                          backend="gloo", timeout=TIMEOUT)
        stdout, stderr = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0 and "TORCH_MESH_ARCHS_JAX_OK" in stdout, stdout + stderr
    with open(out, "rb") as f:
        jax_out = pickle.load(f)
    n = len(ARCHS)
    steps = {shape: [{arch: rk["steps"][i * n + j] for j, arch in enumerate(ARCHS)}
                     for rk in ranks] for i, shape in enumerate(MESHES)}
    m = len(MOE_CASES)
    moe_out = {shape: [rk["moe"][i * m:(i + 1) * m] for rk in ranks]
               for i, shape in enumerate(MESHES)}
    return dict(cases=cases, jax=jax_out, steps=steps, moe=moe, moe_out=moe_out)


def _plain_steps(arch, case):
    """The port's plain steps in this process, from the same state."""
    cfg = reduced_config(arch)
    _, train_step = make_train_step(cfg, remat="none", device="cpu")
    p = from_numpy(case["params"], device="cpu")
    o = adamw_init(p)
    out = {k: [] for k in ("loss", "nll", "aux", "grad_norm")}
    for i, block in enumerate(case["blocks"]):
        t = torch.from_numpy(block)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
                 **{k: torch.from_numpy(v) for k, v in case["stubs"].items()}}
        p, o, m = train_step(p, o, batch, i)
        for k in out:
            out[k].append(float(m[k]))
    out["state"] = {"params": p, "opt": o}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_mesh_steps_match_jax_sharded_steps(runs, arch):
    exp = runs["jax"][arch]
    assert np.all(np.isfinite(exp["loss"]))
    for rank_out in runs["steps"][(2, 2)]:
        got = rank_out[arch]
        for k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-4, atol=0, err_msg=k)
        assert got["experts"] == exp["experts"]


@pytest.mark.parametrize("arch", ARCHS)
def test_1x4_mesh_steps_match_plain_step(runs, arch):
    exp = _plain_steps(arch, runs["cases"][arch])
    for rank_out in runs["steps"][(1, 4)]:
        got = rank_out[arch]
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-5, atol=0, err_msg=k)
        a, b = list(tree_leaves(got["state"])), list(tree_leaves(exp["state"]))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_its_share_of_the_experts(runs, shape):
    tp = shape[1]
    for arch in ("olmoe_1b_7b", "deepseek_v2_236b"):
        E = reduced_config(arch).n_experts
        for rank_out in runs["steps"][shape]:
            rows = rank_out[arch]["experts"]
            assert rows and set(rows.values()) == {E // tp}, rows


def _within_max(got, exp, tol=1e-5):
    """Every element within ``tol`` of ``exp``'s largest magnitude (float32
    sums taken in another order: the batch axes' and "model"'s shares of the
    weights' and the input's gradients are summed across ranks)."""
    assert got.shape == exp.shape and got.dtype == exp.dtype
    assert float((got - exp).abs().max()) <= tol * float(exp.abs().max())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("i", range(len(MOE_CASES)), ids=[f"{a}-{o}" for a, o in MOE_CASES])
def test_apply_moe_on_a_mesh_matches_plain(runs, shape, i):
    cfg, moe, x, r = runs["moe"][i]
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True)) for k, v in moe.items()}
    xr = x.clone().requires_grad_(True)
    y, aux = mlp.apply_moe(p, xr, cfg)
    leaves = list(tree_leaves(p))
    grads = torch.autograd.grad((y * r).sum() + aux, [xr] + leaves)
    T = B * S
    G = mlp.dispatch_groups(T, cfg)
    dest = mlp.route(p, x.reshape(G, T // G, -1), cfg).dest
    dropped = int((dest == cfg.n_experts * mlp.moe_capacity(cfg, T // G)).sum())
    if cfg.capacity_factor == 4.0:
        assert dropped == 0
    else:
        assert dropped > 0
    for got in runs["moe_out"][shape]:
        got = got[i]
        assert torch.equal(got["dest"], dest)
        _within_max(got["out"], y.detach())
        torch.testing.assert_close(got["aux"], aux.detach(), rtol=1e-5, atol=0)
        _within_max(got["dx"], grads[0])
        assert len(got["dp"]) == len(leaves)
        for a, b in zip(got["dp"], grads[1:]):
            _within_max(a, b)
        assert set(got["rows"].values()) == {cfg.n_experts // shape[1]}
