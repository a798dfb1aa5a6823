"""The port's training path (``LM.loss``, ``launch/steps.make_train_step``,
``launch/train.py``) against the JAX package's.

Both packages start from one set of weights (the JAX init, through numpy,
with wq and wk scaled by 0.3 as in tests/test_torch_models.py, which keeps
these narrow float32 models well conditioned; in recurrentgemma's rec
blocks the recurrent branch's input projection w_in is scaled by 0.3 too:
at the plain init a 1e-7 relative change of the embedding alone moves the
port's wa gradient by 1.46 x the tolerance below, so any two float32
orders of summation could disagree by that much; with w_in scaled, 0.3 x). Tolerances: the loss at
2e-5 relative and every gradient within 2e-5 of its leaf's largest
magnitude (float32 sums in another order through four layers and their
backward); a train step's loss, lr and grad_norm at 1e-4 relative. The
train steps are compared from one state each (the port's state reset to
the JAX package's after each step): Adam divides by the root of the second
moment, so a rounding-level difference of a tiny gradient becomes an
lr-sized difference of its parameter, and post-Adam parameters are not a
fair comparison. attn_chunk below S sends attention down the chunked path
(the flash kernel's plain version in the port, the query-chunked remat
attention in the JAX package), above S the plain GQA path. mamba2_780m's
reduced config (S = 32, one chunk of 32) trains through the SSD scan, whose
backward on the card is the ``ssd_scan_bwd`` kernel and here autograd
through its plain version. recurrentgemma_9b's reduced config (a (rec, rec,
local_attn) unit and two rec tail layers) trains through the RG-LRU scan,
whose backward on the card is the ``rglru_scan_bwd`` kernel and here
autograd through its plain version, and through its local attention.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.data import DataConfig as JDataConfig, synthetic_stream as jsynthetic_stream
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import LM as JLM
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy
from repro_torch.optim.adamw import tree_leaves

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)

B, S = 2, 32


def _weights(arch, **overrides):
    """The JAX package's init as numpy, wq and wk scaled by 0.3 (and w_in of
    the rec blocks, stacked and tail)."""
    jm = JLM(dataclasses.replace(j_reduced(arch), **overrides))
    weights = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    for block in weights["stack"].values():
        for name in ("wq", "wk"):
            if name not in block["mixer"]:          # an SSM block (mamba2) has neither
                continue
            w = block["mixer"][name]
            block["mixer"][name] = (w * np.float32(0.3)).astype(w.dtype)
    for group in ("stack", "tail"):
        for block in weights.get(group, {}).values():
            if "w_in" in block["mixer"]:            # an RG-LRU block (recurrentgemma)
                w = block["mixer"]["w_in"]
                block["mixer"]["w_in"] = (w * np.float32(0.3)).astype(w.dtype)
    return jm, weights


def _batch(vocab, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def _grad_close(t, j):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=2e-5 * max(float(np.abs(j).max()), 1e-30))


def _walk(t, j, fn):
    if isinstance(t, dict):
        assert t.keys() == j.keys()
        for key in t:
            _walk(t[key], j[key], fn)
    else:
        assert tuple(t.shape) == j.shape
        fn(t, j)


@pytest.mark.parametrize("arch,attn_chunk,remat,mask", [
    ("qwen3_32b", 64, "full", False),
    ("qwen3_32b", 8, "full", False),       # chunked: the flash kernel's plain version
    ("qwen3_32b", 64, "none", False),
    ("qwen3_32b", 8, "none", False),
    ("granite_8b", 64, "full", False),
    ("granite_8b", 8, "full", False),
    ("granite_8b", 64, "none", False),
    ("granite_8b", 8, "none", False),
    ("qwen3_32b", 8, "full", True),
    ("granite_8b", 64, "none", True),
    ("mamba2_780m", 64, "full", False),    # the SSD scan's backward (its plain version here)
    ("mamba2_780m", 64, "none", True),
    ("recurrentgemma_9b", 64, "full", False),    # the RG-LRU scan's backward (plain here)
    ("recurrentgemma_9b", 8, "full", False),     # and the flash kernel's plain version
    ("recurrentgemma_9b", 64, "none", False),
    ("recurrentgemma_9b", 8, "none", True),
    ("olmoe_1b_7b", 8, "full", False),     # MoE dispatch; the flash kernel's plain version
    ("olmoe_1b_7b", 64, "none", False),
    ("deepseek_v2_236b", 16, "full", False),   # MLA's query chunks inside the unit's remat
    ("deepseek_v2_236b", 64, "none", False),
    ("deepseek_v2_236b", 64, "none", True),
])
def test_loss_and_grads_match_jax(arch, attn_chunk, remat, mask):
    jm, weights = _weights(arch, attn_chunk=attn_chunk)
    tm = build_model(dataclasses.replace(reduced_config(arch), attn_chunk=attn_chunk),
                     device="cpu")
    batch = _batch(tm.cfg.vocab_size, mask=mask)

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, batch), remat=remat)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, weights))

    params = from_numpy(weights, device="cpu")
    leaves = []
    _walk(params, weights, lambda t, _: leaves.append(t.requires_grad_(True)))
    before = launch_counts()
    loss, met = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                        remat=remat)
    grads = iter(torch.autograd.grad(loss, leaves))
    assert launch_counts() == before          # CPU tensors launch no kernel

    assert float(loss.detach()) == pytest.approx(float(jl), rel=2e-5)
    assert float(met["nll"].detach()) == pytest.approx(float(jmet["nll"]), rel=2e-5)
    assert float(met["aux"].detach()) == pytest.approx(float(jmet["aux"]), rel=2e-5)
    _walk(params, jax.tree.map(np.asarray, jg), lambda t, j: _grad_close(next(grads), j))


def test_remat_dots_names_its_roadmap_item():
    """``remat="dots"`` once raised, naming its ROADMAP item; it now runs,
    and its logits equal "full"'s (tests/test_torch_remat_dots.py holds its
    gradients to JAX's)."""
    tm = build_model(reduced_config("qwen3_32b"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    dots, _ = tm.apply(params, toks, remat="dots")
    full, _ = tm.apply(params, toks, remat="full")
    torch.testing.assert_close(dots, full, rtol=0, atol=0)


@pytest.mark.parametrize("arch,attn_chunk,remat", [("qwen3_32b", 8, "full"),
                                                   ("granite_8b", 64, "none"),
                                                   ("mamba2_780m", 64, "full"),
                                                   ("recurrentgemma_9b", 8, "full"),
                                                   ("olmoe_1b_7b", 8, "full"),
                                                   ("deepseek_v2_236b", 16, "full")])
def test_train_step_matches_jax(arch, attn_chunk, remat):
    kw = dict(peak_lr=1e-3, warmup=2, total=10, remat=remat)
    jm, weights = _weights(arch, attn_chunk=attn_chunk)
    cfg = dataclasses.replace(reduced_config(arch), attn_chunk=attn_chunk)
    _, jstep = jmake_train_step(dataclasses.replace(j_reduced(arch), attn_chunk=attn_chunk),
                                **kw)
    jstep = jax.jit(jstep)
    _, tstep = make_train_step(cfg, device="cpu", **kw)
    jparams = jax.tree.map(jnp.asarray, weights)
    jopt = jadamw_init(jparams)
    stream = jsynthetic_stream(JDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                           global_batch=B, seed=1))
    for step in range(3):
        block = next(stream)
        batch = {"tokens": block[:, :-1], "labels": block[:, 1:]}
        params = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        opt = from_numpy(jax.tree.map(np.asarray, jopt), device="cpu")
        params, opt, tout = tstep(params, opt,
                                  {k: torch.from_numpy(v) for k, v in batch.items()}, step)
        jparams, jopt, jout = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batch),
                                    jnp.asarray(step))
        for key in ("loss", "lr", "grad_norm", "nll", "clip_scale", "aux"):
            assert float(tout[key]) == pytest.approx(float(jout[key]), rel=1e-4), (step, key)
        assert tout["aux"].ndim == 0 and not tout["aux"].requires_grad
        assert int(opt["count"]) == int(jopt["count"]) == step + 1
    assert set(tout) == {"loss", "lr", "nll", "aux", "grad_norm", "clip_scale"}


def test_train_launcher_improves_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3_32b", "--reduced",
           "--device", "cpu", "--steps", "20", "--ckpt-dir", ckpt]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    assert "(improved)" in res.stdout, res.stdout
    out = ttrain.main(["--arch", "qwen3_32b", "--reduced", "--device", "cpu", "--steps", "25",
                       "--ckpt-dir", ckpt, "--log-every", "1"])
    printed = capsys.readouterr().out
    assert "restored checkpoint step 20" in printed
    assert out["step0"] == 20 and len(out["losses"]) == 5
    assert "step    20 loss" in printed


def test_train_launcher_trains_recurrentgemma_on_cpu():
    """The reduced recurrentgemma (RG-LRU and local attention) through the
    launcher on the CPU: the loss falls and no kernel launches."""
    before = launch_counts()
    out = ttrain.main(["--arch", "recurrentgemma_9b", "--reduced", "--device", "cpu",
                       "--steps", "20", "--seq", "64", "--global-batch", "4"])
    assert launch_counts() == before
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    assert out["final"] < out["first"]


def test_train_launcher_stubs_raise():
    """The launcher feeds the frontend stubs (whisper's zero frames,
    paligemma's zero patches, in the model's dtype) and trains both reduced
    models on the CPU: the loss falls and no kernel launches."""
    for arch in ("whisper_small", "paligemma_3b"):
        before = launch_counts()
        out = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "20",
                           "--seq", "32", "--global-batch", "4"])
        assert launch_counts() == before
        assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
        assert out["final"] < out["first"], arch


def test_train_launcher_trains_olmoe_on_cpu():
    """The reduced olmoe (MoE at the reference's capacity factor, so slots
    drop) through the launcher on the CPU: the loss falls and no kernel
    launches."""
    before = launch_counts()
    out = ttrain.main(["--arch", "olmoe_1b_7b", "--reduced", "--device", "cpu", "--steps", "20",
                       "--seq", "32", "--global-batch", "4"])
    assert launch_counts() == before
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    assert out["final"] < out["first"]


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.fail("a process group is already up in this test process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b", "whisper_small",
                                  "paligemma_3b"])
def test_train_launcher_trains_under_a_group(arch, one_rank_group):
    """Under a process group (one gloo rank) the launcher trains the MoE,
    MLA, encoder-decoder and VLM models on a (1, 1) mesh, the frontend stubs
    laid out as the batch: the parameters are DTensors, the loss falls and no
    kernel launches."""
    before = launch_counts()
    out = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "20",
                       "--seq", "32", "--global-batch", "4"])
    assert launch_counts() == before
    assert all(hasattr(t, "full_tensor") for t in tree_leaves(out["params"]))
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))
    assert out["final"] < out["first"], arch


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_small"])
def test_train_launcher_restores_sharded_on_two_ranks(tmp_path, arch):
    """olmoe (4 of its 8 experts a rank) and whisper's encoder-decoder
    through the launcher on 2 gloo ranks ((1, 2) mesh) with ``--ckpt-dir``:
    4 steps saved sharded; a restart at the same step count restores the
    state bit for bit and trains nothing; a restart to 6 steps resumes at
    step 4."""
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_mesh_ranks
    from repro_torch.runtime.ranks import run_ranks

    out = run_ranks(torch_mesh_ranks.launcher_ckpt_rank, 2, (arch, str(tmp_path / "ckpt")),
                    backend="gloo", timeout=300)
    E = reduced_config(arch).n_experts
    for r in out:
        assert r["restored_equal"] and r["leaves"] > 0
        assert set(r["experts"].values()) == ({E // 2} if E else set())
        assert r["steps0"] == [0, 4, 4] and r["n_losses"] == [4, 0, 2]
        assert all(np.isfinite(r["losses"]))
    assert out[0]["losses"] == out[1]["losses"]
