"""The port's pipeline executor (``repro_torch.runtime.pipeline``) against a
sequential reference and against the JAX package's ``DoraPipelineExecutor``.

``PipelineSpec.from_plan`` and ``pack_params`` must equal the JAX
package's exactly. The executor runs at the sizes of
``tests/helpers/pipeline_check.py`` (4 stages of 1/3/2/2 tanh layers,
width 16, 8 microbatches of 2): forward and gradients against the layers
applied one after another at 1e-5, with exactly zero gradients in the
padded slots. Against the JAX executor, the JAX side runs in a subprocess
with 4 forced host devices (its mesh needs one a stage; the mesh's axis is
Auto-typed: the JAX executor fails on an Explicit one, the default of
``jax.make_mesh`` in jax 0.9 that tests/helpers/pipeline_check.py uses):
the tanh layer's forward and the gradient of ``loss`` (``jax.grad``
against autograd) at 1e-5, and a reduced h2o-danube dense block (float32, wq and wk scaled by
0.3 to keep the narrow model well conditioned, as in
tests/test_torch_models.py) at 2e-5 of each leaf's largest magnitude.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plans import ParallelismPlan as JPlan
from repro.core.plans import Stage as JStage
from repro.runtime.pipeline import PipelineSpec as JPipelineSpec
from repro.runtime.pipeline import _pad_stage_params
from repro_torch import dora
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import ParallelismPlan, QoESpec, Stage, Workload
from repro_torch.models.convert import from_numpy
from repro_torch.models.registry import planning_graph
from repro_torch.models.transformer import apply_block
from repro_torch.runtime.pipeline import (DistributedPipelineExecutor, DoraPipelineExecutor,
                                          PipelineSpec, pack_params, stage_block, unpack_params)
from repro_torch.runtime.ranks import run_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks  # noqa: E402  (the ranks' functions, importable by the spawned processes)

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, L, D = 4, 8, 16          # stages, layers, width (pipeline_check's)
M, MB = 8, 2                # microbatches, microbatch size
SPLITS = [1, 3, 2, 2]


def _plan(splits, n_micro, mb):
    stages, lo = [], 0
    for s, n in enumerate(splits):
        stages.append(Stage(node_ids=list(range(lo, lo + n)), devices=[s],
                            microbatch_split={s: 1.0}))
        lo += n
    return ParallelismPlan(stages=stages, microbatch_size=mb, n_microbatches=n_micro)


def _card_plans():
    """The plans of the issue's table: (plan, n_layers)."""
    out = []
    for arch, setting, wl, qoe in [
            ("granite_8b", "smart_home_2", Workload(4, 1, training=False), QoESpec(0.2, lam=100.0)),
            ("h2o_danube_1_8b", "traffic_monitor", Workload(8, 2, training=True),
             QoESpec(8.0, lam=50.0)),
            ("h2o_danube_1_8b", "edge_cluster", Workload(4, 1, training=False),
             QoESpec(0.2, lam=100.0)),
            ("h2o_danube_1_8b", "smart_home_2", Workload(4, 1, training=False),
             QoESpec(0.2, lam=100.0))]:
        cfg = get_config(arch)
        plan = dora.serve(setting, graph=planning_graph(cfg, 4096), qoe=qoe, workload=wl).current
        out.append((plan, cfg.n_layers))
    return out


def _to_jax_plan(plan):
    return JPlan(stages=[JStage(node_ids=list(s.node_ids), devices=list(s.devices),
                                microbatch_split=dict(s.microbatch_split)) for s in plan.stages],
                 microbatch_size=plan.microbatch_size, n_microbatches=plan.n_microbatches)


def test_spec_matches_jax_on_the_card_plans_and_pipeline_check():
    cases = _card_plans() + [(_plan(SPLITS, M, MB), L), (_plan([2, 1, 1], 3, 1), 10),
                             (_plan([5, 1, 1, 1], 2, 4), 3)]
    want_layers = [(12, 11, 13), (8, 7, 5, 4), (20, 4), (24,), (1, 3, 2, 2)]
    for i, (plan, n_layers) in enumerate(cases):
        got = PipelineSpec.from_plan(plan, n_layers)
        want = JPipelineSpec.from_plan(_to_jax_plan(plan), n_layers)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), i
        if i < len(want_layers):
            assert got.layers_per_stage == want_layers[i]


def test_pack_params_matches_jax_exactly_and_unpacks():
    rng = np.random.default_rng(0)
    stacked = {"w": rng.standard_normal((L, D, D)).astype(np.float32),
               "inner": {"b": rng.standard_normal((L, D)).astype(np.float32),
                         "n": rng.integers(-5, 5, (L, 3)).astype(np.int32)}}
    spec = PipelineSpec.from_plan(_plan(SPLITS, M, MB), L)
    jspec = JPipelineSpec.from_plan(_to_jax_plan(_plan(SPLITS, M, MB)), L)
    want = _pad_stage_params({k: (jnp.asarray(v) if not isinstance(v, dict) else
                                  {kk: jnp.asarray(vv) for kk, vv in v.items()})
                              for k, v in stacked.items()}, jspec)
    got = pack_params(from_numpy(stacked, "cpu"), spec)
    for g, w in ((got["w"], want["w"]), (got["inner"]["b"], want["inner"]["b"]),
                 (got["inner"]["n"], want["inner"]["n"])):
        assert g.shape == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = unpack_params(got, spec)
    np.testing.assert_array_equal(back["w"].numpy(), stacked["w"])
    np.testing.assert_array_equal(back["inner"]["n"].numpy(), stacked["inner"]["n"])


def _tanh_layer(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def _tanh_weights(dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(0)
    stacked = {"w": (torch.randn((L, D, D), generator=g) * 0.3).to(device, dtype),
               "b": (torch.randn((L, D), generator=g) * 0.1).to(device, dtype)}
    x = torch.randn((M, MB, D), generator=g).to(device, dtype)
    r = torch.randn((M, MB, D), generator=g).to(device, dtype)
    return stacked, x, r


def _sequential_check(device, tol):
    stacked, x, r = _tanh_weights(device=device)
    ex = DoraPipelineExecutor(_plan(SPLITS, M, MB), L, _tanh_layer)
    packed = {k: v.clone().requires_grad_(True) for k, v in ex.pack_params(stacked).items()}
    xg = x.clone().requires_grad_(True)
    loss = ex.loss(packed, xg, lambda o: (o * r).sum())
    loss.backward()

    ref_p = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    xr = x.clone().requires_grad_(True)
    y = xr
    for i in range(L):
        y = _tanh_layer({"w": ref_p["w"][i], "b": ref_p["b"][i]}, y)
    (y * r).sum().backward()
    with torch.no_grad():
        out = ex.forward(packed, x)
    torch.testing.assert_close(out, y.detach(), atol=tol, rtol=tol)
    torch.testing.assert_close(xg.grad, xr.grad, atol=tol, rtol=tol)
    for k in stacked:
        torch.testing.assert_close(ex.unpack_params(packed[k].grad), ref_p[k].grad,
                                   atol=tol, rtol=tol)
        for s, n in enumerate(ex.spec.layers_per_stage):     # padded slots: exactly zero
            assert bool((packed[k].grad[s, n:] == 0).all())
    return ex


def test_executor_matches_sequential_reference():
    ex = _sequential_check("cpu", 1e-5)
    assert ex.spec.layers_per_stage == (1, 3, 2, 2) and ex.spec.pad == 3


def test_executor_schedule_runs_each_stage_once_a_microbatch_and_skips_padding():
    """M + S - 1 ticks, stage s on microbatch t - s at tick t, padded slots
    never called; with grad on, each stage call is recomputed once in the
    backward (the stage's remat)."""
    stacked, x, r = _tanh_weights()
    calls = []

    def layer(lp, y):
        calls.append(int(lp["i"]))
        return _tanh_layer(lp, y)
    stacked = dict(stacked, i=torch.arange(L, dtype=torch.float32))
    ex = DoraPipelineExecutor(_plan(SPLITS, M, MB), L, layer)
    packed = ex.pack_params(stacked)
    with torch.no_grad():
        ex.forward(packed, x)
    assert len(calls) == L * M
    # tick-major order: at tick t the stages holding microbatches run in order
    want = []
    bounds = np.cumsum([0] + SPLITS)
    for t in range(M + S - 1):
        for s in range(S):
            if 0 <= t - s < M:
                want += list(range(bounds[s], bounds[s + 1]))
    assert calls == want
    calls.clear()
    p = {k: v.clone().requires_grad_(k != "i") for k, v in packed.items()}
    ex.loss(p, x, lambda o: (o * r).sum()).backward()
    assert len(calls) == 2 * L * M


def test_executor_takes_one_device_a_stage_and_checks_their_number():
    stacked, x, _ = _tanh_weights()
    ex = DoraPipelineExecutor(_plan(SPLITS, M, MB), L, _tanh_layer, devices=["cpu"] * S)
    with torch.no_grad():
        out = ex.forward(ex.pack_params(stacked), x)
    assert out.shape == x.shape and out.device == x.device
    with pytest.raises(ValueError, match="4 stages but 3 devices"):
        DoraPipelineExecutor(_plan(SPLITS, M, MB), L, _tanh_layer, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="8 microbatches"):
        ex.forward(ex.pack_params(stacked), x[:3])


# -- against the JAX executor -----------------------------------------------------------
JAX_SIDE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import reduced_config
from repro.core.plans import ParallelismPlan, Stage
from repro.launch.mesh import use_mesh
from repro.models.transformer import LM, apply_block
from repro.runtime.pipeline import DoraPipelineExecutor

def plan(splits, m, mb):
    stages, lo = [], 0
    for s, n in enumerate(splits):
        stages.append(Stage(node_ids=list(range(lo, lo + n)), devices=[s],
                            microbatch_split={s: 1.0}))
        lo += n
    return ParallelismPlan(stages=stages, microbatch_size=mb, n_microbatches=m)

out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)

def run(name, splits, n_layers, layer_fn, stacked, x, r):
    # an Auto-typed mesh: under jax 0.9's default (Explicit) axis types the
    # JAX executor's closed-over n_valid cannot enter its shard_map
    mesh = jax.make_mesh((4,), ("stage",), axis_types=(jax.sharding.AxisType.Auto,))
    ex = DoraPipelineExecutor(plan(splits, x.shape[0], x.shape[1]), n_layers, mesh, layer_fn)
    packed = ex.pack_params(stacked)
    with use_mesh(mesh):
        y = ex.forward(packed, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: ex.loss(p, x, lambda o: jnp.sum(o * r)),
                                  argnums=(0, 1)))(packed, x)
    put(name + "/stacked", stacked)
    put(name + "/x", x)
    put(name + "/r", r)
    put(name + "/out", y)
    put(name + "/grad_packed", gp)
    put(name + "/grad_x", gx)

rng = np.random.default_rng(0)
f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
run("tanh", [1, 3, 2, 2], 8, lambda lp, x: jnp.tanh(x @ lp["w"] + lp["b"]),
    {"w": f32(8, 16, 16) * np.float32(0.3), "b": f32(8, 16) * np.float32(0.1)},
    f32(8, 2, 16), f32(8, 2, 16))

cfg = dataclasses.replace(reduced_config("h2o_danube_1_8b"), n_layers=6)
stack = jax.tree.map(np.asarray, LM(cfg).init(jax.random.PRNGKey(0))["stack"]["u0"])
for k in ("wq", "wk"):
    stack["mixer"][k] = stack["mixer"][k] * np.float32(0.3)
run("h2o", [1, 2, 2, 1], 6,
    lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train")[0],
    stack, f32(4, 2, 40, cfg.d_model), f32(4, 2, 40, cfg.d_model))
np.savez(sys.argv[2], **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_pipeline") / "out.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, os.path.abspath(SRC), path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX_SIDE_OK" in res.stdout, res.stdout + res.stderr[-4000:]
    with np.load(path) as z:
        flat = dict(z)
    return flat


def _tree(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("name,splits,tol", [("tanh", SPLITS, 1e-5), ("h2o", [1, 2, 2, 1], 2e-5)])
def test_executor_matches_jax(jax_side, name, splits, tol):
    if name == "tanh":
        layer_fn, n_layers = _tanh_layer, L
    else:
        cfg = dataclasses.replace(reduced_config("h2o_danube_1_8b"), n_layers=6)
        n_layers = 6

        def layer_fn(lp, x):
            return apply_block(lp, x, cfg, "dense", mode="train")
    stacked = from_numpy(_tree(jax_side, f"{name}/stacked"), "cpu")
    x = torch.from_numpy(jax_side[f"{name}/x"])
    r = torch.from_numpy(jax_side[f"{name}/r"])
    ex = DoraPipelineExecutor(_plan(splits, x.shape[0], x.shape[1]), n_layers, layer_fn)
    packed = ex.pack_params(stacked)
    leaves = list(_leaves(packed))
    params = [t.clone().requires_grad_(True) for _, t in leaves]
    tree = _tree({f"p{k}": v for (k, _), v in zip(leaves, params)}, "p")
    xg = x.clone().requires_grad_(True)
    loss = ex.loss(tree, xg, lambda o: (o * r).sum())
    grads = torch.autograd.grad(loss, params + [xg])
    with torch.no_grad():
        _close(ex.forward(packed, x), jax_side[f"{name}/out"], tol, "forward")
    _close(grads[-1], jax_side[f"{name}/grad_x"], tol, "grad x")
    want = dict(_leaves(_tree(jax_side, f"{name}/grad_packed")))
    assert sorted(want) == sorted(k for k, _ in leaves)
    for (key, _), g in zip(leaves, grads[:-1]):
        _close(g, want[key], tol, key)
        for s, n in enumerate(ex.spec.layers_per_stage):     # padded slots: exactly zero
            assert bool((g[s, n:] == 0).all()) and not np.any(want[key][s, n:])


# -- one rank a stage (DistributedPipelineExecutor) on gloo CPU ranks ------------------------
RANKS_TIMEOUT = 120          # seconds for a whole run_ranks call; the group's ops time out too


def _h2o_block_cfg():
    return dataclasses.replace(reduced_config("h2o_danube_1_8b"), n_layers=6)


def _case(jax_side, name):
    """(cfg or None for the tanh layer, splits, n_layers, stacked, x, r)."""
    cfg, splits, n_layers = (None, SPLITS, L) if name == "tanh" else \
        (_h2o_block_cfg(), [1, 2, 2, 1], 6)
    return (cfg, splits, n_layers, from_numpy(_tree(jax_side, f"{name}/stacked"), "cpu"),
            torch.from_numpy(jax_side[f"{name}/x"]), torch.from_numpy(jax_side[f"{name}/r"]))


@pytest.fixture(scope="module")
def ranks_side(jax_side):
    """Both cases through DistributedPipelineExecutor on 4 gloo CPU ranks,
    in one run: {name: [rank 0's result, ..., rank 3's]}."""
    names = ("tanh", "h2o")
    per_rank = run_ranks(torch_ranks.pipeline_rank, 4, ([_case(jax_side, n) for n in names],),
                         backend="gloo", timeout=RANKS_TIMEOUT)
    return {n: [res[i] for res in per_rank] for i, n in enumerate(names)}


def test_stage_block_is_a_block_of_pack_params():
    stacked, _, _ = _tanh_weights()
    spec = PipelineSpec.from_plan(_plan(SPLITS, M, MB), L)
    packed = pack_params(stacked, spec)
    for s in range(S):
        for k in stacked:
            assert torch.equal(stage_block(stacked, spec, s)[k], packed[k][s])


@pytest.mark.parametrize("name,splits,tol", [("tanh", SPLITS, 1e-5), ("h2o", [1, 2, 2, 1], 2e-5)])
def test_ranks_match_in_process_executor_and_jax(jax_side, ranks_side, name, splits, tol):
    """One rank a stage (4 gloo CPU ranks, ranks 1-3 handed x as NaNs)
    against the in-process executor and the JAX executor: the forward
    output on every rank, the loss on every rank, each rank's block
    gradient (padded slots exactly zero) and rank 0's gradient of x, at the
    file's tolerances; each rank runs its true layers in 2M forward stage
    calls (``forward``, then ``loss_and_grads``'s, which keeps the layer
    inputs) and M backward ones, in microbatch order."""
    cfg, splits, n_layers, stacked, x, r = _case(jax_side, name)
    ex = DoraPipelineExecutor(_plan(splits, x.shape[0], x.shape[1]), n_layers,
                              torch_ranks.layer_fn(cfg))
    packed = ex.pack_params(stacked)
    leaves = list(_leaves(packed))
    params = [t.clone().requires_grad_(True) for _, t in leaves]
    tree = _tree({f"p{k}": v for (k, _), v in zip(leaves, params)}, "p")
    xg = x.clone().requires_grad_(True)
    loss = ex.loss(tree, xg, lambda o: (o * r).sum())
    grads = torch.autograd.grad(loss, params + [xg])
    with torch.no_grad():
        out = ex.forward(packed, x)
    per_rank = ranks_side[name]
    for rank, res in enumerate(per_rank):
        _close(res["out"], jax_side[f"{name}/out"], tol, f"rank {rank} forward vs JAX")
        _close(res["out"], out.numpy(), tol, f"rank {rank} forward vs in-process")
        assert abs(float(res["loss"]) - loss.item()) <= tol * abs(loss.item()), rank
        n, M_ = ex.spec.layers_per_stage[rank], ex.spec.n_microbatches
        assert res["calls"] == [("forward", n)] * (2 * M_) + [("backward", n, n)] * M_
        assert (res["grad_x"] is None) == (rank > 0)
    _close(per_rank[0]["grad_x"], jax_side[f"{name}/grad_x"], tol, "grad x vs JAX")
    _close(per_rank[0]["grad_x"], grads[-1].numpy(), tol, "grad x vs in-process")
    want = dict(_leaves(_tree(jax_side, f"{name}/grad_packed")))
    for (key, _), g in zip(leaves, grads[:-1]):
        got = torch.stack([dict(_leaves(res["grads"]))[key] for res in per_rank])
        _close(got, want[key], tol, f"{key} vs JAX")
        _close(got, g.numpy(), tol, f"{key} vs in-process")
        for s, n in enumerate(ex.spec.layers_per_stage):     # padded slots: exactly zero
            assert bool((got[s, n:] == 0).all())


def test_distributed_executor_refuses_a_plan_of_another_size(tmp_path):
    """The plan's stage count must be the group's size (here a group of one
    rank, this process)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="plan has 4 stages but the process group has 1"):
            DistributedPipelineExecutor(_plan(SPLITS, M, MB), L, _tanh_layer)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("how,timeout,error,match", [
    ("raise", RANKS_TIMEOUT, torch.multiprocessing.ProcessRaisedException,
     "rank 1 raised:(.|\n)*rank 1 failed on purpose"),
    ("hang", 5, TimeoutError, r"ranks \[0, 1\] of 2 still running after 5 s")])
def test_run_ranks_reports_a_failed_or_hung_rank_within_its_timeout(how, timeout, error, match):
    """A rank that raises while its peer waits in ``recv`` for it: the
    parent raises with that rank's traceback at once; ranks that outlive
    the timeout: the parent kills them and raises ``TimeoutError``."""
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        run_ranks(torch_ranks.failing_rank, 2, (how,), backend="gloo", timeout=timeout)
    assert time.monotonic() - t0 < min(timeout, 60) + 10


# -- the slice as a whole ------------------------------------------------------------------
@pytest.mark.parametrize("attn_chunk", [64, 8])
def test_planned_pipeline_training_loss_matches_jax_lm_loss(attn_chunk):
    """Plan h2o-danube-1.8b's training on traffic_monitor with the port's
    planner (4 stages), run a reduced float32 h2o-family model of 8 layers
    through that plan's executor (3/2/2/1, 4 microbatches of 2): embed, the
    stages, then ``LM.loss_from_hidden`` once on the whole output; the loss
    and every gradient against ``jax.grad`` of the JAX package's
    ``LM.loss`` on the batch of 8, at 2e-5 (tests/test_torch_train.py's
    tolerance). attn_chunk 8 < S sends attention down the flash kernel's
    plain version, 64 the plain GQA path."""
    import jax

    from repro.configs import reduced_config as jreduced
    from repro.models.transformer import LM as JLM
    from repro_torch.models import build_model

    plan = dora.serve("traffic_monitor", graph=planning_graph(get_config("h2o_danube_1_8b"), 4096),
                      qoe=QoESpec(8.0, lam=50.0), workload=Workload(8, 2, training=True)).current
    assert plan.n_stages == 4
    over = dict(n_layers=8, attn_chunk=attn_chunk)
    jm = JLM(dataclasses.replace(jreduced("h2o_danube_1_8b"), **over))
    weights = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    for name in ("wq", "wk"):
        w = weights["stack"]["u0"]["mixer"][name]
        weights["stack"]["u0"]["mixer"][name] = (w * np.float32(0.3)).astype(w.dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch), remat="full")[0])(weights)

    cfg = dataclasses.replace(reduced_config("h2o_danube_1_8b"), **over)
    model = build_model(cfg, device="cpu")
    ex = DoraPipelineExecutor(plan, cfg.n_layers,
                              lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train"))
    assert ex.spec.layers_per_stage == (3, 2, 2, 1)
    params = from_numpy(weights, "cpu")
    tree = {k: v for k, v in params.items() if k != "stack"}
    tree["packed"] = ex.pack_params(params["stack"]["u0"])
    leaves = list(_leaves(tree))
    p_list = [t.clone().requires_grad_(True) for _, t in leaves]
    p = _tree({f"p{k}": v for (k, _), v in zip(leaves, p_list)}, "p")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x = p["embed"][tb["tokens"].long()].view(4, 2, 32, cfg.d_model)
    loss = ex.loss(p["packed"], x,
                   lambda o: model.loss_from_hidden(p, o.reshape(8, 32, cfg.d_model), tb))
    grads = dict(zip((k for k, _ in leaves), torch.autograd.grad(loss, p_list)))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=2e-5)
    stacked = ex.unpack_params(_tree({f"g{k[len('/packed'):]}": v for k, v in grads.items()
                                      if k.startswith("/packed/")}, "g"))
    want = dict(_leaves(j_grads))
    for key, g in dict(_leaves(stacked)).items():
        _close(g, want["/stack/u0" + key], 2e-5, key)
    for key in ("/embed", "/ln_f", "/unembed"):
        _close(grads[key], want[key], 2e-5, key)
