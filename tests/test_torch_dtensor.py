"""The kernels' DTensor entry (``repro_torch.kernels.ops``) and AdamW on
DTensor leaves, on gloo CPU ranks.

The attention entry takes its ``"local"`` branch (each rank its own heads
or batch rows) or its ``"replicate"`` branch (q, k, v gathered, the output
back in q's placements); both are held to ``flash_attention_ref`` on the
whole tensors, forward and the gradients of sum(out * r), including the
layout the reduced granite of the reference's elastic helpers gets at tp 4
(wq head-sharded, wk/wv replicated: H 4 sharded, KV 2 replicated). AdamW
on DTensor leaves must equal the plain update bit for bit on a one-rank
mesh, and on two ranks wherever the clip does not bind (the norm is then a
sum of partial sums, to f32 rounding).
"""
import os
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding_utils import P, distribute_tree
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks  # noqa: E402  (the ranks' functions, importable by spawned processes)

torch.set_num_threads(2)

HEADS = P(None, None, "model", None)
BATCH_HEADS = P("data", None, "model", None)
SEQ = P(None, "model", None, None)
REP = P()


def _qkv(seed, B, S, H, KV, d=16):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, d, generator=g) for n in (H, KV, KV))
    return q, k, v, torch.randn(B, S, H, d, generator=g)


# (name, mesh, (B, S, H, KV), specs of q, k, v, window, branch)
CASES = [
    ("heads", (1, 4), (2, 16, 8, 4), (HEADS, HEADS, HEADS), None, "local"),
    ("heads_window", (1, 4), (2, 16, 8, 4), (HEADS, HEADS, HEADS), 5, "local"),
    ("batch_and_heads", (2, 2), (2, 16, 4, 2), (BATCH_HEADS,) * 3, None, "local"),
    ("granite_tp4_mixed", (1, 4), (2, 16, 4, 2), (HEADS, REP, REP), None, "replicate"),
    ("sequence", (1, 4), (2, 16, 8, 4), (SEQ, SEQ, SEQ), None, "replicate"),
    ("all_replicated", (1, 4), (2, 16, 6, 2), (REP, REP, REP), None, "local"),
]


@pytest.fixture(scope="module")
def attention_runs():
    cases = []
    for i, (_, mesh, (B, S, H, KV), specs, window, _) in enumerate(CASES):
        q, k, v, r = _qkv(i, B, S, H, KV)
        cases.append((mesh, q, k, v, specs, window, r))
    out = run_ranks(torch_mesh_ranks.attention_rank, 4, (cases,), backend="gloo", timeout=300)
    return cases, out


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_dtensor_attention_matches_plain(attention_runs, i):
    cases, out = attention_runs
    _, q, k, v, _, window, r = cases[i]
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    exp = flash_attention_ref(q, k, v, causal=True, window=window)
    grads = torch.autograd.grad((exp * r).sum(), (q, k, v))
    for rank_out in out:
        got = rank_out["cases"][i]
        assert got["branch"] == [CASES[i][5]], got
        torch.testing.assert_close(got["out"], exp.detach(), rtol=1e-5, atol=1e-6)
        for g, e in zip(got["grads"], grads):
            torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)
        # the output comes back in q's placements
        assert got["out_placements"] == got["in_placements"][0]


def test_dtensor_branch_counts(attention_runs):
    cases, out = attention_runs
    exp = [c[5] for c in CASES]
    for rank_out in out:
        assert [o["branch"][0] for o in rank_out["cases"]] == exp


def test_maybe_shard_on_four_ranks(attention_runs):
    """The residual stream's spec on a (1, 4) mesh: "pod" absent and dropped,
    "data" of one rank replicated, the sequence over "model"; then moved to
    the last dim over ("data", "model"); the whole value unchanged."""
    _, out = attention_runs
    for rank_out in out:
        got = rank_out["maybe_shard"]
        assert got["y"] == ["R", "S(1)"] and got["local_y"] == (2, 2, 12)
        assert got["z"] == ["R", "S(2)"] and got["local_z"] == (2, 8, 3)
        assert got["equal"]


def test_plain_tensors_take_no_branch():
    q, k, v, _ = _qkv(0, 1, 8, 2, 1)
    before = dict(ops.dtensor_branch)
    torch.testing.assert_close(ops.flash_attention(q, k, v), flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert ops.dtensor_branch == before


# -- AdamW -----------------------------------------------------------------------------
def _adamw_tree(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((4,)).astype(np.float32)),
              "stack": {"u": torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(
                  np.float32)).to(torch.bfloat16)}}
    grads = {k: v for k, v in zip(("w", "b"), (
        torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)) * grad_scale,
        torch.from_numpy(rng.standard_normal((4,)).astype(np.float32)) * grad_scale))}
    grads["stack"] = {"u": (torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(np.float32))
                            * grad_scale).to(torch.bfloat16)}
    specs = {"w": P("model", None), "b": P(None), "stack": {"u": P(None, "data", "model")}}
    return params, grads, specs


def _plain_adamw(params, grads, steps):
    p = {k: (v.clone() if not isinstance(v, dict) else {n: t.clone() for n, t in v.items()})
         for k, v in params.items()}
    state = adamw_init(p)
    for _ in range(steps):
        p, state, metrics = adamw_update(grads, state, p, 1e-2)
    return p, state, metrics


def _assert_tree(a, b, exact):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype
        if exact:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grad_scale, exact", [(0.01, True), (10.0, False)],
                         ids=["clip_idle", "clip_binds"])
def test_adamw_on_dtensor_leaves_two_ranks(grad_scale, exact):
    params, grads, specs = _adamw_tree(1, grad_scale)
    exp_p, exp_state, exp_m = _plain_adamw(params, grads, 3)
    assert (float(exp_m["clip_scale"]) == 1.0) == exact
    out = run_ranks(torch_mesh_ranks.adamw_rank, 2,
                    ((1, 2), params, grads, specs, 1e-2, 3), backend="gloo", timeout=300)
    for o in out:
        assert all(o["is_dtensor"])
        _assert_tree(o["params"], exp_p, exact)
        _assert_tree(o["m"], exp_state["m"], exact)
        _assert_tree(o["v"], exp_state["v"], exact)
        assert int(o["count"]) == 3 and o["count"].dtype == torch.int32
        torch.testing.assert_close(o["metrics"]["grad_norm"], exp_m["grad_norm"], rtol=1e-6,
                                   atol=0)
        assert not isinstance(o["metrics"]["grad_norm"], DTensor)


@pytest.fixture(scope="module")
def one_rank_group():
    if dist.is_initialized():
        pytest.fail("a process group is already up in this test process")
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_adamw_on_dtensor_leaves_one_rank_bitwise(one_rank_group):
    """On a (1, 1) mesh every sum runs as on plain tensors: the update, the
    norm and the clip scale equal the plain ones bit for bit, with the clip
    binding."""
    params, grads, specs = _adamw_tree(2, 10.0)
    exp_p, exp_state, exp_m = _plain_adamw(params, grads, 2)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    p = distribute_tree(params, specs, mesh)
    g = distribute_tree(grads, specs, mesh)
    state = adamw_init(p)
    assert isinstance(state["m"]["w"], DTensor) and not isinstance(state["count"], DTensor)
    for _ in range(2):
        p, state, metrics = adamw_update(g, state, p, 1e-2)
    _assert_tree({k: v for k, v in torch_mesh_ranks.gather(p, True).items()}, exp_p, True)
    _assert_tree(torch_mesh_ranks.gather(state["m"], True), exp_state["m"], True)
    _assert_tree(torch_mesh_ranks.gather(state["v"], True), exp_state["v"], True)
    for k in ("grad_norm", "clip_scale"):
        assert not isinstance(metrics[k], DTensor) and torch.equal(metrics[k], exp_m[k])
    assert float(exp_m["clip_scale"]) < 1.0


def test_mixed_dtensor_and_plain_inputs_raise(one_rank_group):
    q, k, v, _ = _qkv(0, 1, 8, 2, 1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    dq = distribute_tree({"q": q}, {"q": HEADS}, mesh)["q"]
    with pytest.raises(TypeError, match="DTensors of one mesh"):
        ops.flash_attention(dq, k, v)
    with pytest.raises(TypeError, match="DTensors of one mesh"):
        ops.decode_attention(dq[:, :1], k, v, torch.full((1,), 8, dtype=torch.int32))


def test_mesh_takes_the_ranks_device_and_refuses_other_tensors(one_rank_group):
    """The mesh's device type is the rank's device, never the backend's
    name, and ``distribute`` refuses a tensor of another device type instead
    of moving it onto the mesh's (a card's parameters would land on the
    host)."""
    with pytest.raises(ValueError, match="pass the rank's device"):
        make_mesh((1, 1), ("data", "model"))          # not started by run_ranks
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="a meta tensor on a cpu mesh"):
        distribute_tree({"w": torch.empty(4, 4, device="meta")}, {"w": P()}, mesh)


def test_run_ranks_mesh_is_on_each_ranks_device():
    """Gloo ranks that ``run_ranks`` starts on the CPU get a CPU mesh from
    ``make_host_mesh()`` and refuse a tensor of another device type."""
    outs = run_ranks(torch_mesh_ranks.mesh_device_rank, 2, backend="gloo", timeout=60)
    assert [o["device_type"] for o in outs] == ["cpu", "cpu"]
    assert all("a meta tensor on a cpu mesh" in o["refused"] for o in outs)
