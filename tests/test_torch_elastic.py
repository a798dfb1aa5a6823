"""The port's elastic controller (``repro_torch.runtime.elastic``), sharded
checkpoints and DTensor train steps on gloo CPU ranks, against the JAX
package.

* ``tests/helpers/elastic_check.py`` (8 -> 4) and ``elastic_cascade_check.py``
  (8 -> 4 -> 2) ported: the same reduced granite_8b (2 layers, d 64, H 4,
  KV 2, head_dim 16, vocab 256) and batch shape (8, 17), 3 steps on a (1, 8)
  mesh, a sharded checkpoint, then the ranks past the survivors fall silent
  and exit; the survivors regroup into a group of their own, restore bit for
  bit, and train on. The generation counter rises by one a shrink, and the
  failed ranks' processes are gone before the survivors regroup.
* Parity with the JAX package (its side in a subprocess with 8 forced host
  devices, ``tests/torch_elastic_jax.py``): the JAX package's sharded steps
  on a (1, 8) mesh against the port's 8-rank steps from the same numpy
  weights and batches, each step from JAX's state before it (loss within
  1e-4); a port checkpoint written by 8 ranks restored by the JAX
  ``Checkpointer`` onto a 4-device mesh, and a JAX one (8 devices) onto the
  port's ranks at (2, 4), both bit for bit.
* A (2, 2) mesh step (FSDP over "data", TP over "model") against the plain
  one-process step.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models.transformer import LM as JLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import from_numpy
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402  (the ranks' functions, importable by spawned processes)

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
TIMEOUT = 420


def _elastic(world, shrinks, tmp_path):
    ckpt, pids = tmp_path / "ckpt", tmp_path / "pids"
    pids.mkdir()
    return run_ranks(torch_mesh_ranks.elastic_rank, world, (shrinks, str(ckpt), str(pids)),
                     backend="gloo", timeout=TIMEOUT)


def _check_elastic(out, world, shrinks):
    alive = world
    for g, n in enumerate(shrinks, start=1):
        for r in range(n, alive):          # the failed ranks stopped at generation g - 1
            assert out[r]["generations"] == list(range(g)), out[r]
        alive = n
    for r in range(alive):
        o = out[r]
        assert o["generations"] == list(range(len(shrinks) + 1))     # strictly monotone
        assert o["worlds"] == [world] + list(shrinks)
        assert o["restored_equal"] == [True] * len(shrinks)          # bit for bit
        assert o["gone_before_regroup"] == [True] * len(shrinks)
        assert all(np.isfinite(o["losses"]))
        assert len(o["losses"]) == len(shrinks) + 1
    prev = world
    for i, n in enumerate(shrinks):
        assert out[0]["failed"][i] == list(range(n, prev))
        prev = n
    # every survivor computed the same losses
    assert all(out[r]["losses"] == out[0]["losses"] for r in range(alive))


def test_elastic_restart_8_to_4_ranks(tmp_path):
    out = _elastic(8, [4], tmp_path)
    _check_elastic(out, 8, [4])
    # at (1, 4) wq is head-sharded and wk/wv replicated (H 4, KV 2): the
    # attention takes the replicate branch, once a layer
    assert out[0]["branches"] == [{"local": 0, "replicate": 2}]


def test_elastic_cascading_failure_8_to_4_to_2(tmp_path):
    out = _elastic(8, [4, 2], tmp_path)
    _check_elastic(out, 8, [4, 2])
    # at (1, 2) both wq and wk/wv are head-sharded: the local branch
    assert out[0]["branches"] == [{"local": 0, "replicate": 2}, {"local": 2, "replicate": 0}]


# -- parity with the JAX package ------------------------------------------------------
def _jax(what, inp, tmp_path, ckpt):
    inp_path, out_path = tmp_path / f"{what}_in.pkl", tmp_path / f"{what}_out.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, os.path.join(HERE, "torch_elastic_jax.py"), what,
                          str(inp_path), str(out_path), str(ckpt)],
                         capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert res.returncode == 0 and "TORCH_ELASTIC_JAX_OK" in res.stdout, \
        res.stdout + res.stderr
    with open(out_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_parity")
    cfg = torch_mesh_ranks.elastic_cfg()
    params = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(0)))
    blocks = [torch_mesh_ranks.batch_tokens(cfg, s) for s in range(3)]
    jax_steps = _jax("steps", {"params": params, "blocks": blocks}, tmp, tmp / "jax_ckpt")
    port = run_ranks(torch_mesh_ranks.parity_rank, 8,
                     (jax_steps["states"], blocks, list(range(3)), str(tmp / "jax_ckpt"),
                      str(tmp / "port_ckpt"), jax_steps["final"]),
                     backend="gloo", timeout=TIMEOUT)
    jax_restore = _jax("restore", {"expected": jax_steps["final"]}, tmp, tmp / "port_ckpt")
    return dict(jax_steps=jax_steps, port=port, jax_restore=jax_restore)


def test_port_sharded_steps_match_jax_sharded_steps(parity):
    exp = parity["jax_steps"]["losses"]
    assert parity["jax_steps"]["embed_shards"] == 8
    for rank_out in parity["port"]:
        np.testing.assert_allclose(rank_out["losses"], exp, rtol=1e-4, atol=0)


def _assert_bitwise(got_np_tree, exp_np_tree):
    got = jax.tree.leaves(got_np_tree)
    exp = jax.tree.leaves(exp_np_tree)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def test_port_checkpoint_of_8_ranks_restores_in_jax_on_4_devices(parity):
    out = parity["jax_restore"]
    _assert_bitwise(out["restored"], parity["jax_steps"]["final"])
    assert set(jax.tree.leaves(out["devices"])) == {4}


def test_jax_checkpoint_of_8_devices_restores_on_port_ranks(parity):
    exp = parity["jax_steps"]["final"]
    for rank_out in parity["port"]:
        got = jax.tree.map(lambda t: t.numpy(), rank_out["restored"])
        _assert_bitwise(got, exp)
        # on the (2, 4) mesh wq is FSDP-sharded over "data" and head-sharded over "model"
        assert rank_out["restored_placements"]["wq"] == ["S(1)", "S(2)"]


def test_2x2_mesh_step_matches_one_rank_step():
    """FSDP over "data" and TP over "model" on a (2, 2) mesh against the
    plain step in this process, from the same state, on two batches."""
    cfg = torch_mesh_ranks.elastic_cfg()
    params_np = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(1)))
    opt_np = {"m": jax.tree.map(np.zeros_like, params_np),
              "v": jax.tree.map(np.zeros_like, params_np), "count": np.zeros((), np.int32)}
    blocks = [torch_mesh_ranks.batch_tokens(cfg, 20 + i) for i in range(2)]
    out = run_ranks(torch_mesh_ranks.mesh_step_rank, 4, ((2, 2), params_np, opt_np, blocks),
                    backend="gloo", timeout=TIMEOUT)
    _, train_step = make_train_step(cfg, remat="none", device="cpu")
    for i, block in enumerate(blocks):
        p = from_numpy(params_np, device="cpu")
        o = adamw_init(p)
        t = torch.from_numpy(block)
        p, o, m = train_step(p, o, {"tokens": t[:, :-1], "labels": t[:, 1:]}, i)
        for rank_out in out:
            np.testing.assert_allclose(rank_out["loss"][i], float(m["loss"]), rtol=1e-5)
            np.testing.assert_allclose(rank_out["grad_norm"][i], float(m["grad_norm"]),
                                       rtol=1e-5)
    for rank_out in out:
        for a, b in zip(tree_leaves(rank_out["state"]), tree_leaves({"params": p, "opt": o})):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
