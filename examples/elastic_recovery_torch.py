"""Fault tolerance end to end on the PyTorch port — checkpoint, lose half
the fleet, resume.

One rank a device (``runtime.ranks.run_ranks``: gloo ranks on the CPU, one
nccl rank a card): trains a tiny model on a (1, ranks) ("data", "model")
mesh with a sharded checkpoint, lets half the ranks go silent, and shows
the elastic controller regroup the survivors, Dora replan for them and the
resharded restore resume training on the smaller mesh.

The steps are those of ``examples/elastic_recovery.py`` (8 devices → 4 by
default), plus ``--ranks`` and ``--device`` (the cards unless asked
otherwise). With ``--device cuda`` it needs a card a rank, and exits
non-zero when there are fewer; it never carries on on the CPU.

    PYTHONPATH=src python examples/elastic_recovery_torch.py --device cpu
    PYTHONPATH=src python examples/elastic_recovery_torch.py --ranks 4
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import dora
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.core.cost_model import Workload
from repro_torch.core.device import CATALOG, Topology
from repro_torch.core.graph_builders import GraphSpec, build_lm_graph
from repro_torch.core.qoe import QoESpec
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.sharding import ShardingRules, train_state_specs
from repro_torch.models.sharding_utils import P, distribute, distribute_tree
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import ElasticController, ElasticState, ranks
from repro_torch.scenarios import Scenario


def model_cfg():
    return dataclasses.replace(reduced_config("granite_8b"), n_layers=2,
                               d_model=64, d_ff=128, vocab_size=256,
                               n_heads=4, n_kv_heads=2, head_dim=16)


def batch(cfg, mesh, seed: int, device):
    """An (8, 16) batch, replicated on ``mesh`` from ``device`` (the rank's)."""
    t = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (8, 17)).astype(np.int32)).to(device)
    return {"tokens": distribute(t[:, :-1].contiguous(), P(), mesh),
            "labels": distribute(t[:, 1:].contiguous(), P(), mesh)}


def survivors_scenario(cfg, n: int) -> Scenario:
    """The fleet after the loss: ``n`` rtx4050 boards on one shared medium,
    an ad-hoc Scenario (the facade takes unregistered deployments too)."""
    devs = [CATALOG["rtx4050"]] * n
    spec = GraphSpec("m", cfg.n_layers, cfg.d_model, cfg.n_heads,
                     cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size, seq_len=16)
    return Scenario(
        name="home_survivors",
        description=f"Smart-home fleet after losing {n} of {2 * n} devices",
        topology=lambda: Topology.shared_medium(devs, 600.0),
        model=lambda seq_len: build_lm_graph(spec, seq_len=seq_len),
        workload=Workload(global_batch=8, microbatch_size=1,
                          optimizer_mult=3.0),
        qoe=QoESpec(t_qoe=1.0, lam=10.0), seq_len=16)


def rank_main(rank: int, world: int, ckpt_dir: str) -> dict:
    """One rank's run (see the module docstring); rank 0 tells the story."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = model_cfg()
    model, train_step = make_train_step(cfg, remat="none", device=ranks.rank_device())
    mesh = make_host_mesh()
    out = {"losses": []}
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    say(f"training on {world} ranks ({dist.get_backend()}, {model.device.type})...")
    with use_mesh(mesh):
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
        params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
        opt = adamw_init(params)
        for step in range(4):
            params, opt, m = train_step(params, opt, batch(cfg, mesh, step, model.device), step)
            out["losses"].append(float(m["loss"]))
            say(f"  step {step} loss {out['losses'][-1]:.4f}")
        ckpt.save(4, {"params": params, "opt": opt}, wait=True)
    say("checkpoint committed at step 4")
    shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                      {"params": params, "opt": opt})
    del params, opt

    n = world // 2
    ctrl = ElasticController(
        make_mesh=lambda k: make_host_mesh(),
        spec_fn=lambda m, tree: train_state_specs(ShardingRules(cfg, m), tree),
        ckpt=ckpt, n_devices=world)
    for t in (1.0, 2.0, 3.0, 4.0):            # every rank is fed the same beats
        for d in range(n):
            ctrl.coordinator.beat(d, t)
    failed = ctrl.coordinator.tick(5.0)
    out["failed"] = sorted(failed)
    say(f"\nheartbeat detector: ranks {out['failed']} FAILED "
        f"(healthy: {ctrl.coordinator.healthy})")
    ranks.leave()                              # nothing touches the old group again
    if rank >= n:                              # a failed rank goes silent
        return out

    # Dora replans for the shrunk fleet (planner view of the same event)
    replan = dora.plan(survivors_scenario(cfg, n)).result
    out["n_stages"] = replan.best.n_stages
    say(f"Dora replanned for {n} survivors in {replan.total_s:.2f}s: "
        f"{out['n_stages']} stages")

    state = ctrl.remesh(ElasticState(mesh=mesh, step=4, params=None, opt_state=None), shapes)
    out.update(world=dist.get_world_size(), generation=state.generation, step=state.step)
    say(f"restored step {state.step} onto a {state.mesh.size()}-rank mesh (generation "
        f"{state.generation})")
    with use_mesh(state.mesh):
        _, _, m = train_step(state.params, state.opt_state,
                             batch(cfg, state.mesh, 99, model.device), 5)
    out["resumed_loss"] = float(m["loss"])
    say(f"training resumed: step 5 loss {out['resumed_loss']:.4f}")
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        raise SystemExit(f"--ranks {args.ranks}: half of them fail, so an even count >= 2")
    devices = None
    backend = "gloo"
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.ranks:
            raise SystemExit(f"elastic_recovery_torch: {args.ranks} ranks on cuda need a card "
                             f"each, {have} visible (pass --device cpu for gloo ranks)")
        devices, backend = [f"cuda:{i}" for i in range(args.ranks)], "nccl"
    with tempfile.TemporaryDirectory() as ckpt_dir:
        results = ranks.run_ranks(rank_main, args.ranks, (ckpt_dir,), backend=backend,
                                  timeout=600.0, devices=devices)
    return results[0]


if __name__ == "__main__":
    main()
