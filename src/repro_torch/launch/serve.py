"""Batched serving driver with Dora-planned placement and a QoE monitor:
plan the deployment with the port's copy of Dora's planner, prefill a
batch of synthetic prompts, then greedy-decode, reporting prefill time and
per-token decode latency against the QoE target. With ``--dynamics`` it
feeds a mid-run slowdown to the runtime adapter and prints its decision
(paper Fig. 16 behavior at example scale).

    python -m repro_torch.launch.serve --arch qwen3_32b [--reduced] [--device cuda]
        [--setting smart_home_2] [--dynamics]
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3_32b \
        --reduced --device cpu

whisper_small gets zero encoder frames and paligemma_3b zero patch
embeddings (the frontend stubs, as in the JAX launcher, in the model's
dtype); paligemma's cache holds its patches too, and its decode positions
start after them.

With a process group (``torchrun``, which this launcher joins over nccl on
the card it is given and gloo on the CPU, or ranks started by
``runtime.ranks.run_ranks``) it serves under the JAX launcher's mesh: every
rank of the group as a (1, world) ('data', 'model') mesh, the parameters
laid out by ``ShardingRules.param_specs``, the cache by ``cache_specs``
(its sequence over "model": each rank decodes against its own slots and
the ranks merge, ``kernels/ops.py``) and the prompt, positions and stubs by
``batch_specs`` (``generate``); rank 0 prints. Without one, the model runs
on one device. The plan is printed, and the pipeline executor that runs a
plan's stages is ``repro_torch.runtime.pipeline``.

``--setting`` takes any registered scenario (``python -m
repro_torch.scenarios --list``).
An infeasible plan raises, as in the JAX package (qwen3_32b at the 200 ms
default does: ``--t-qoe-ms`` loosens the target).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import dora
from ..configs import get_config, reduced_config
from ..core import DynamicsEvent, QoESpec, Workload
from ..models.registry import planning_graph
from ..models.sharding import ShardingRules
from ..models.sharding_utils import distribute_tree, is_dtensor, relayout, rows_of, summed
from .mesh import make_host_mesh, use_mesh
from ..models import build_model
from .steps import (_plain, frontend_stubs, init_serving_cache, lay_out_serving,
                    prefill_logits)
from .train import _join_torchrun


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax token of each row's logits (B, 1, V) -> (B, 1) int32; under
    a mesh the vocabulary is gathered first, each rank keeping its batch
    rows."""
    if is_dtensor(logits):
        logits = relayout(summed(logits), rows_of(logits))
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(model, params, tokens: torch.Tensor, extras: Dict[str, torch.Tensor],
             gen_len: int, *, mesh=None, keep_logits: bool = False,
             on_step: Optional[Callable[[int], None]] = None,
             max_len: Optional[int] = None) -> dict:
    """Prefill ``tokens`` (B, S) after the frontend stubs ``extras``, then
    ``gen_len`` greedy decode steps, on one device or under ``mesh`` (with
    ``params`` laid out by ``param_specs``): the cache made by
    ``init_serving_cache``, the prompt, each step's ``pos`` and the stubs
    laid out by ``lay_out_serving``, as the reference's ``serve_structs``.
    The cache holds ``max_len`` positions (the stubs', the prompt's and the
    steps' when None). Returns the tokens (B, gen_len + 1) as a plain
    tensor, the prefill's and every step's host-clock ms (synchronised),
    with ``keep_logits`` every step's last-position logits (B, V) float32,
    whole, and the cache. ``on_step(i)`` runs after the prefill (i = -1)
    and after step i."""
    cfg = model.cfg
    B, S = tokens.shape
    dev = model.device
    offset = cfg.n_patches if cfg.vision_stub else 0

    def place(tree):
        return tree if mesh is None else lay_out_serving(cfg, mesh, tree, B)
    cache = init_serving_cache(model, B, max_len or offset + S + gen_len, mesh)
    laid = place({"tokens": tokens, "extras": extras})
    logits_out: List[torch.Tensor] = []

    def keep(logits):
        if keep_logits:
            logits_out.append(_plain(logits)[:, -1].float())
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_logits(model, params, laid["tokens"], cache, laid["extras"])
        tok = greedy(logits)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        keep(logits)
        if on_step is not None:
            on_step(-1)
        toks, lat = [tok], []
        for i in range(gen_len):
            pos = place({"pos": torch.full((B,), offset + S + i, dtype=torch.int32,
                                           device=dev)})["pos"]
            t1 = time.perf_counter()
            logits, cache = model.decode(params, tok, cache, pos)
            tok = greedy(logits)
            _sync(dev)
            lat.append((time.perf_counter() - t1) * 1e3)
            keep(logits)
            toks.append(tok)
            if on_step is not None:
                on_step(i)
    return {"tokens": torch.cat([_plain(t) for t in toks], dim=1), "prefill_ms": prefill_ms,
            "decode_ms": lat, "logits": logits_out, "cache": cache}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--t-qoe-ms", type=float, default=200.0)
    ap.add_argument("--dynamics", action="store_true")
    ap.add_argument("--setting", default="smart_home_2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    joined = _join_torchrun(args.device)
    try:
        return _serve(args, cfg)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, cfg) -> dict:
    model = build_model(cfg, device=args.device)
    dev = model.device
    mesh = make_host_mesh(dev) if dist.is_initialized() else None
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)

    # --- Dora plans the edge deployment for this model --------------------
    # the setting's fleet + this invocation's model/batch/QoE via overrides
    session = dora.serve(
        args.setting, graph=planning_graph(cfg, args.prompt_len),
        qoe=QoESpec(t_qoe=args.t_qoe_ms / 1e3, lam=100.0),
        workload=Workload(global_batch=args.batch, microbatch_size=1, training=False))
    result = session.report.result
    adapter = session.adapter
    say("Dora plan:", result.best.summary())
    say(f"planning took {result.total_s*1e3:.0f}ms "
        f"(phase1 {result.phase1_s*1e3:.0f}ms, phase2 {result.phase2_s*1e3:.0f}ms)")

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        params = distribute_tree(params, ShardingRules(cfg, mesh).param_specs(params), mesh)
    # the VLM's patches go before the prompt, in the cache too (the JAX
    # launcher sizes its cache without them, and then every decode write
    # clamps into the last slot)
    extras = frontend_stubs(cfg, args.batch, dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
                             dtype=torch.int32, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    where = f"on {name}" if mesh is None else \
        (f"on a {tuple(mesh.shape)} ('data', 'model') mesh of {dist.get_world_size()} ranks "
         f"({dist.get_backend()}, {name})")
    say(f"{cfg.name}: {cfg.n_layers} layers {where}")

    t0 = time.perf_counter()
    dynamics = None

    def on_step(i: int) -> None:
        nonlocal dynamics
        if args.dynamics and i == args.gen_len // 2:
            ev = DynamicsEvent(t=time.perf_counter() - t0, compute_speed={0: 0.6},
                               bandwidth_scale={"wifi": 0.7})
            plan, action, dt = adapter.on_dynamics(result.best, ev)
            say(f"  [dynamics] adapter action={action} in {dt*1e3:.0f}ms; "
                f"plan latency {result.best.latency*1e3:.0f} -> "
                f"{plan.latency*1e3:.0f}ms")
            dynamics = {"action": action, "plan": plan, "react_s": dt}
    out = generate(model, params, tokens, extras, args.gen_len, mesh=mesh, on_step=on_step)
    prefill_ms = out["prefill_ms"]
    say(f"prefill({args.prompt_len} tokens): {prefill_ms:.1f}ms")
    lat = np.array(out["decode_ms"][1:] if len(out["decode_ms"]) > 1 else out["decode_ms"])
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    say(f"decode: p50={p50:.1f}ms p99={p99:.1f}ms QoE target={args.t_qoe_ms:.0f}ms "
        f"({'MET' if p99 < args.t_qoe_ms else 'MISSED'} locally)")
    return {"prefill_ms": prefill_ms, "p50_ms": p50, "p99_ms": p99,
            "last_token": out["tokens"][:, -1:].cpu().numpy(), "plan": result.best,
            "plan_summary": result.best.summary(), "planning_s": result.total_s,
            "dynamics": dynamics, "mesh": None if mesh is None else tuple(mesh.shape)}


if __name__ == "__main__":
    main()
