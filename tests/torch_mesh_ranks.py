"""Rank functions for the tests of the port's mesh, sharding rules, DTensor
kernel entry and elastic controller: the ranks started by
``repro_torch.runtime.ranks.run_ranks`` import this module by name, so it
imports neither jax nor the JAX package (and the spawned processes stay
cheap to start). Everything comes back as plain CPU tensors."""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_mesh, use_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import from_numpy
from repro_torch.models.sharding import ShardingRules, train_state_specs
from repro_torch.models.sharding_utils import P, distribute, distribute_tree, maybe_shard
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import ElasticController, ElasticState, ranks

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import gather, wait_gone  # noqa: E402


def elastic_cfg():
    """The reference elastic helpers' reduced granite_8b (float32)."""
    return dataclasses.replace(reduced_config("granite_8b"), n_layers=2, d_model=64,
                               d_ff=128, vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=16)


def batch_tokens(cfg, seed: int) -> np.ndarray:
    """An (8, 17) token block (the reference helpers' batch shape)."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)


def place_batch(block: np.ndarray, mesh, spec=P()):
    t = torch.from_numpy(block)
    return {"tokens": distribute(t[:, :-1].contiguous(), spec, mesh),
            "labels": distribute(t[:, 1:].contiguous(), spec, mesh)}


def meta_like(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def mesh_device_rank(rank, world):
    """The device type of this rank's ``make_host_mesh()``, the error that
    ``distribute`` raises for a tensor of another type (a meta tensor on
    the CPU, a CPU tensor on a card), and on a card the flash forward run on
    a head-sharded DTensor there: its launches and its output's device."""
    mesh = make_host_mesh()
    dev = ranks.rank_device()
    other = torch.empty(4, 4, device="meta" if dev.type == "cpu" else "cpu")
    try:
        distribute(other, P(), mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    out = dict(device_type=mesh.device_type, refused=refused)
    if dev.type == "cuda":
        from repro_torch import kernels
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(1, 128, h, 64, generator=g, device=dev, dtype=torch.bfloat16)
                   for h in (4, 2, 2))
        spec = P(None, None, "model", None)
        before = kernels.launch_counts()["flash_attention"]
        o = ops.flash_attention(*(distribute(t, spec, mesh) for t in (q, k, v)))
        out.update(launches=kernels.launch_counts()["flash_attention"] - before,
                   out_device=o.to_local().device.type)
    return out


def elastic_rank(rank, world, shrinks, ckpt_dir, pid_dir):
    """The reference's elastic check (``shrinks`` = [4]: 8 -> 4) and cascade
    ([4, 2]: 8 -> 4 -> 2) on ``world`` gloo ranks: 3 steps on a (1, world)
    mesh, a sharded checkpoint, then for each shrink the healthy ranks past
    ``n`` fall silent (every rank is fed the same beats) and exit; the
    survivors regroup, restore onto (1, n), check the restore bit for bit
    against the saved state, take a step and checkpoint it."""
    cfg = elastic_cfg()
    model, train_step = make_train_step(cfg, remat="none", device="cpu")
    mesh = make_host_mesh()
    params = model.init(torch.Generator().manual_seed(0))
    params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
    opt = adamw_init(params)
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    out = {"losses": [], "generations": [0], "worlds": [world], "restored_equal": [],
           "gone_before_regroup": [], "failed": [], "branches": []}
    with use_mesh(mesh):
        for step in range(3):
            params, opt, m = train_step(params, opt, place_batch(batch_tokens(cfg, step), mesh),
                                        step)
        out["losses"].append(float(m["loss"]))
        ckpt.save(3, {"params": params, "opt": opt}, wait=True)
    saved = gather({"params": params, "opt": opt}, True)
    shapes = meta_like(saved)

    def mesh_of(n):
        m = make_host_mesh()
        assert m.size() == n, (m, n)
        return m

    def spec_fn(m, tree_shapes):
        return train_state_specs(ShardingRules(cfg, m), tree_shapes)

    ctrl = ElasticController(make_mesh=mesh_of, spec_fn=spec_fn, ckpt=ckpt, n_devices=world)
    state = ElasticState(mesh=mesh, step=3, params=None, opt_state=None)
    t, alive = 0.0, world
    for n in shrinks:
        for beat in (t + 1, t + 2, t + 3, t + 4):
            for d in range(n):
                ctrl.coordinator.beat(d, beat)
        failed = ctrl.coordinator.tick(t + 5)
        t += 5
        out["failed"].append(sorted(failed))
        assert ctrl.needs_remesh()
        ranks.leave()             # nothing touches the old group again
        if rank >= n:             # silent: exit
            with open(os.path.join(pid_dir, f"{rank}.pid"), "w") as f:
                f.write(str(os.getpid()))
            return out
        out["gone_before_regroup"].append(wait_gone(pid_dir, range(n, alive)))
        before = dict(ops.dtensor_branch)
        state = ctrl.remesh(state, shapes)
        out["generations"].append(state.generation)
        out["worlds"].append(dist.get_world_size())
        restored = gather({"params": state.params, "opt": state.opt_state}, True)
        out["restored_equal"].append(all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(tree_leaves(saved), tree_leaves(restored))))
        with use_mesh(state.mesh):
            p, o, m = train_step(state.params, state.opt_state,
                                 place_batch(batch_tokens(cfg, 10 * state.generation),
                                             state.mesh), state.step)
            out["losses"].append(float(m["loss"]))
            ckpt.save(state.step + 1, {"params": p, "opt": o}, wait=True)
        out["branches"].append({k: ops.dtensor_branch[k] - before[k] for k in before})
        saved = gather({"params": p, "opt": o}, True)
        state = dataclasses.replace(state, step=state.step + 1, params=p, opt_state=o)
        alive = n
    return out


def attention_rank(rank, world, cases):
    """Each case ``(mesh_shape, q, k, v, specs, window, r)``: q, k, v laid
    out by ``specs`` on a ("data", "model") mesh, through
    ``ops.flash_attention``; the output and the gradients of sum(out * r),
    whole, and the DTensor branch taken."""
    out = []
    mesh = make_mesh((1, world), ("data", "model"))
    x = torch.arange(2 * 8 * 12, dtype=torch.float32).reshape(2, 8, 12)
    dx = distribute(x, P(), mesh)
    with use_mesh(mesh):
        y = maybe_shard(dx, P(("pod", "data"), "model", None))     # pod absent: dropped
        z = maybe_shard(y, P(None, None, ("data", "model")))       # a shard moved
        w = maybe_shard(z, P(None, "model", None))
    shard = dict(y=[str(p) for p in y.placements], z=[str(p) for p in z.placements],
                 equal=all(torch.equal(t.full_tensor(), x) for t in (y, z, w)),
                 local_y=tuple(y.to_local().shape), local_z=tuple(z.to_local().shape))
    for mesh_shape, q, k, v, specs, window, r in cases:
        mesh = make_mesh(mesh_shape, ("data", "model"))
        dq, dk, dv = (distribute(t, s, mesh).requires_grad_(True)
                      for t, s in zip((q, k, v), specs))
        before = dict(ops.dtensor_branch)
        o = ops.flash_attention(dq, dk, dv, causal=True, window=window)
        branch = [b for b in before if ops.dtensor_branch[b] != before[b]]
        loss = (o * distribute(r, P(), mesh)).sum()
        grads = torch.autograd.grad(loss.full_tensor(), (dq, dk, dv))
        out.append(dict(out=o.full_tensor().detach(), grads=[g.full_tensor() for g in grads],
                        branch=branch, out_placements=[str(p) for p in o.placements],
                        in_placements=[[str(p) for p in t.placements] for t in (dq, dk, dv)]))
    return {"cases": out, "maybe_shard": shard}


def adamw_rank(rank, world, mesh_shape, params, grads, specs, lr, steps):
    """``adamw_update`` on DTensor leaves laid out by ``specs``, ``steps``
    times from a fresh state; the parameters, moments and metrics, whole."""
    mesh = make_mesh(mesh_shape, ("data", "model"))
    p = distribute_tree(params, specs, mesh)
    g = distribute_tree(grads, specs, mesh)
    state = adamw_init(p)
    for _ in range(steps):
        p, state, metrics = adamw_update(g, state, p, lr)
    return dict(params=gather(p, True), m=gather(state["m"], True), v=gather(state["v"], True),
                count=state["count"], metrics=metrics,
                is_dtensor=[hasattr(t, "full_tensor") for t in tree_leaves(p)])


def mesh_step_rank(rank, world, mesh_shape, params_np, opt_np, blocks):
    """One train step of the elastic config on a ("data", "model") mesh of
    ``mesh_shape`` per token block (the batch over "data"), each from the
    given state; the losses, grad norms and the state after the last."""
    cfg = elastic_cfg()
    _, train_step = make_train_step(cfg, remat="none", device="cpu")
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rules = ShardingRules(cfg, mesh)
    out = {"loss": [], "grad_norm": []}
    with use_mesh(mesh):
        for i, block in enumerate(blocks):
            tree = from_numpy({"params": params_np, "opt": opt_np}, device="cpu")
            tree = distribute_tree(tree, train_state_specs(rules, tree), mesh)
            p, o, m = train_step(tree["params"], tree["opt"],
                                 place_batch(block, mesh, P(("pod", "data"), None)), i)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    out["state"] = gather({"params": p, "opt": o}, True)
    return out


def parity_rank(rank, world, states_np, blocks, steps0, ckpt_in, ckpt_out, save_np):
    """The JAX package's sharded steps on the port's ranks: step i from
    JAX's state before it (``states_np[i]``) on a (1, world) mesh, its loss;
    then the JAX checkpoint ``ckpt_in`` (saved from JAX's 8-device mesh)
    restored onto a (2, world/2) mesh, whole; and ``save_np`` saved
    sharded from (1, world) into ``ckpt_out``."""
    cfg = elastic_cfg()
    _, train_step = make_train_step(cfg, remat="none", device="cpu")
    mesh = make_host_mesh()
    rules = ShardingRules(cfg, mesh)
    losses = []
    with use_mesh(mesh):
        for state_np, block, step in zip(states_np, blocks, steps0):
            tree = from_numpy(state_np, device="cpu")
            tree = distribute_tree(tree, train_state_specs(rules, tree), mesh)
            _, _, m = train_step(tree["params"], tree["opt"], place_batch(block, mesh), step)
            losses.append(float(m["loss"]))
    tree = from_numpy(save_np, device="cpu")
    Checkpointer(ckpt_out, async_save=False).save(
        5, distribute_tree(tree, train_state_specs(rules, tree), mesh), wait=True)
    mesh2 = make_mesh((2, world // 2), ("data", "model"))
    from repro_torch.runtime.elastic import sharded_targets
    shapes = meta_like(tree)
    targets = sharded_targets(shapes, train_state_specs(ShardingRules(cfg, mesh2), shapes), mesh2)
    back = Checkpointer(ckpt_in).restore(3, targets)
    return dict(losses=losses, restored=gather(back, True),
                restored_placements={"wq": [str(p) for p in
                                            back["params"]["stack"]["u0"]["mixer"]["wq"]
                                            .placements]})


def compress_rank(rank, world, tree, steps):
    """``ef_compress`` over ``tree`` (name -> (tensor, spec)) laid out on a
    (1, world) mesh (spec "partial": each rank holds a share of the tensor,
    summed across "model" when read), ``steps`` times with the residual
    carried; also ``quantize_int8``'s scale of each leaf. Returns the
    gathered outputs, residuals, norms, scales and int8 codes, and whether
    every output is laid out as its residual, with no pending sum."""
    from repro_torch.optim import ef_compress, ef_init, quantize_int8
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = make_host_mesh()
    grads = {}
    for k, (t, spec) in tree.items():
        if spec == "partial":     # pending sums, as a gradient may come: rank r holds (r + 1) parts
            share = t * (rank + 1) / (world * (world + 1) / 2)
            grads[k] = DTensor.from_local(share, mesh, [Replicate(), Partial()])
        else:
            grads[k] = distribute(t, spec, mesh)
    out = {"scales": {}, "codes": {}, "deq": [], "res": [], "norms": [], "laid_out": True}
    for k, g in grads.items():
        q, s = quantize_int8(g)
        out["laid_out"] &= isinstance(q, DTensor) and not any(p.is_partial() for p in q.placements)
        out["scales"][k], out["codes"][k] = s, q.full_tensor()
    ef = ef_init(grads)
    for _ in range(steps):
        deq, ef, m = ef_compress(grads, ef)
        out["laid_out"] &= all(d.placements == ef[k].placements and
                               not any(p.is_partial() for p in d.placements)
                               for k, d in deq.items())
        out["deq"].append({k: d.full_tensor() for k, d in deq.items()})
        out["res"].append({k: e.full_tensor() for k, e in ef.items()})
        out["norms"].append(m["ef_residual_norm"])
    return out


def _arch_batch(cfg, block, stubs_np, mesh):
    """A token block (B, S + 1) and the frontend stubs, laid out on ``mesh``
    as the launcher lays them out (the batch over the batch axes)."""
    batch = place_batch(block, mesh, P(("pod", "data"), None))
    stubs = {k: torch.from_numpy(v) for k, v in stubs_np.items()}
    if stubs:
        batch.update(distribute_tree(stubs, ShardingRules(cfg, mesh).batch_specs(
            stubs, block.shape[0]), mesh))
    return batch


def expert_rows(params) -> dict:
    """path -> this rank's rows of each expert leaf (its local dim 0, past the
    stacked layer dim where there is one)."""
    out = {}
    for group in ("stack", "tail"):
        for name, block in params.get(group, {}).items():
            for leaf in ("w_up", "w_gate", "w_down"):
                if "moe" in block and leaf in block["moe"]:
                    t = block["moe"][leaf]
                    out[f"{group}/{name}/moe/{leaf}"] = t.to_local().shape[1 if group == "stack"
                                                                          else 0]
    return out


def arch_steps_rank(rank, world, cases):
    """Each case ``(arch, mesh_shape, state_np, blocks, stubs_np)``: the
    reduced arch's train steps (remat "none", the launcher's make_train_step)
    on a ("data", "model") mesh of ``mesh_shape`` from ``state_np`` (params
    and AdamW state, numpy), one a token block, carried from step to step;
    each step's loss, nll, aux and grad norm, the state after the last
    (whole) and each expert leaf's local rows."""
    out = []
    for arch, mesh_shape, state_np, blocks, stubs_np in cases:
        cfg = reduced_config(arch)
        _, train_step = make_train_step(cfg, remat="none", device="cpu")
        mesh = make_mesh(mesh_shape, ("data", "model"))
        tree = from_numpy(state_np, device="cpu")
        tree = distribute_tree(tree, train_state_specs(ShardingRules(cfg, mesh), tree), mesh)
        p, o = tree["params"], tree["opt"]
        rec = {k: [] for k in ("loss", "nll", "aux", "grad_norm")}
        rec["experts"] = expert_rows(p)
        with use_mesh(mesh):
            for i, block in enumerate(blocks):
                p, o, m = train_step(p, o, _arch_batch(cfg, block, stubs_np, mesh), i)
                for k in ("loss", "nll", "aux", "grad_norm"):
                    rec[k].append(float(m[k]))
        rec["state"] = gather({"params": p, "opt": o}, True)
        out.append(rec)
    return out


def moe_apply_rank(rank, world, cases):
    """Each case ``(arch, overrides, mesh_shape, moe_np, x, r)``: ``apply_moe``
    of one layer's MoE weights (laid out as ``ShardingRules`` lays out an
    unstacked MoE layer) on x (B, S, D), laid out as the block gives it
    (batch over the batch axes) on a ("data", "model") mesh; the output, aux
    loss, the gradients of sum(out * r) + aux (whole), the routing's rows
    (whole) and the expert leaves' local rows."""
    from repro_torch.models import mlp
    from repro_torch.models.sharding import map_with_path
    out = []
    for arch, overrides, mesh_shape, moe_np, x, r in cases:
        cfg = dataclasses.replace(reduced_config(arch), **overrides)
        mesh = make_mesh(mesh_shape, ("data", "model"))
        rules = ShardingRules(cfg, mesh)
        p = from_numpy(moe_np, device="cpu")
        specs = map_with_path(lambda path, t: rules.param_spec(path, t.shape), {"moe": p},
                              "tail/t0/")["moe"]
        p = distribute_tree(p, specs, mesh)
        leaves = list(tree_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
        dx = distribute(x, P(("pod", "data"), None, None), mesh).requires_grad_(True)
        with use_mesh(mesh):
            y, aux = mlp.apply_moe(p, dx, cfg)
            B, S, D = x.shape
            G = mlp.dispatch_groups(B * S, cfg)
            xg = maybe_shard(dx.detach().reshape(G, B * S // G, D), P(("pod", "data"), None, None))
            dest = mlp.route(p, xg, cfg).dest
        loss = (y * distribute(r, P(), mesh)).sum() + aux
        grads = torch.autograd.grad(loss.full_tensor(), [dx] + leaves)
        out.append(dict(out=y.full_tensor().detach(), aux=aux.full_tensor().detach(),
                        dx=grads[0].full_tensor(), dp=[g.full_tensor() for g in grads[1:]],
                        dest=dest.full_tensor(), rows={k: t.to_local().shape[0] for k, t in
                                                       p.items() if k != "router" and
                                                       k != "shared"},
                        placements={k: [str(q) for q in t.placements] for k, t in p.items()
                                    if k in ("w_up", "w_down")}))
    return out


def mesh_archs_rank(rank, world, step_cases, moe_cases):
    """``arch_steps_rank`` and ``moe_apply_rank`` in one start of the ranks."""
    return {"steps": arch_steps_rank(rank, world, step_cases),
            "moe": moe_apply_rank(rank, world, moe_cases)}


def launcher_ckpt_rank(rank, world, arch, ckpt_dir):
    """The train launcher (``launch.train.main``) on this group: ``arch``
    reduced, 4 steps saved sharded into ``ckpt_dir``; the same run again
    (restores step 4, trains nothing: its state against the first run's,
    bit for bit); then 6 steps (resumes at 4)."""
    from repro_torch.launch import train as ttrain
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "32",
            "--global-batch", "4", "--ckpt-every", "2", "--ckpt-dir", ckpt_dir, "--steps"]
    runs = [ttrain.main(args + [str(n)]) for n in (4, 4)]
    saved, restored = (gather({"params": r["params"], "opt": r["opt"]}, True) for r in runs)
    a, b = list(tree_leaves(saved)), list(tree_leaves(restored))
    equal = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                     for x, y in zip(a, b))
    experts = expert_rows(runs[0]["params"])
    runs.append(ttrain.main(args + ["6"]))
    return dict(restored_equal=equal, leaves=len(a), experts=experts,
                steps0=[r["step0"] for r in runs], n_losses=[len(r["losses"]) for r in runs],
                losses=runs[0]["losses"] + runs[2]["losses"])


def serve_rank(rank, world, cases):
    """Each case ``(arch, overrides, mesh_shape, params_np, tokens, stubs_np,
    gen)``: the reduced arch (``overrides`` applied) served by
    ``launch.serve.generate`` on a ("data", "model") mesh of ``mesh_shape``,
    the parameters (numpy) laid out by ``param_specs``, the cache by
    ``cache_specs``, the prompt, positions and stubs by ``batch_specs``:
    prefill and ``gen`` greedy steps. Each step's logits (whole), the
    tokens, the DTensor attention branches taken by the decode steps and
    each cache leaf's placements."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    out = []
    for arch, overrides, mesh_shape, params_np, tokens, stubs_np, gen in cases:
        cfg = dataclasses.replace(reduced_config(arch), **dict(overrides))
        model = build_model(cfg, device="cpu")
        mesh = make_mesh(mesh_shape, ("data", "model"))
        params = from_numpy(params_np, device="cpu")
        params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
        stubs = {k: torch.from_numpy(v) for k, v in stubs_np.items()}
        before = {}

        def after_prefill(i):
            if i < 0:
                before.update(ops.decode_branch)
        res = generate(model, params, torch.from_numpy(tokens), stubs, gen, mesh=mesh,
                       keep_logits=True, on_step=after_prefill)
        placements = {}

        def walk(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{path}/{k}")
                else:
                    placements[f"{path}/{k}"] = [str(p) for p in v.placements]
        walk(res["cache"])
        out.append(dict(logits=res["logits"], tokens=res["tokens"], placements=placements,
                        branches={k: ops.decode_branch[k] - before[k] for k in before}))
    return out


def serve_launcher_rank(rank, world, argv):
    """The serve launcher (``launch.serve.main``) on this group: its last
    greedy tokens and its mesh."""
    from repro_torch.launch import serve
    out = serve.main(argv)
    return dict(last_token=torch.from_numpy(out["last_token"]), mesh=out["mesh"])
