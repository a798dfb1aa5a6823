"""Rank functions for the tests of ``DistributedPipelineExecutor``: the
ranks started by ``repro_torch.runtime.ranks.run_ranks`` import this
module by name, so it imports neither jax nor the JAX package (and the
spawned processes stay cheap to start)."""
import time

import torch
import torch.distributed as dist

from repro_torch.core import ParallelismPlan, Stage
from repro_torch.runtime.pipeline import DistributedPipelineExecutor, PipelineSpec, stage_block


def plan(splits, n_micro, mb):
    stages, lo = [], 0
    for s, n in enumerate(splits):
        stages.append(Stage(node_ids=list(range(lo, lo + n)), devices=[s],
                            microbatch_split={s: 1.0}))
        lo += n
    return ParallelismPlan(stages=stages, microbatch_size=mb, n_microbatches=n_micro)


def tanh_layer(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def layer_fn(cfg):
    """The tanh layer without a config, else ``cfg``'s dense block."""
    if cfg is None:
        return tanh_layer
    from repro_torch.models.transformer import apply_block
    return lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train")


def pipeline_rank(rank, world, cases):
    """Rank ``rank``'s stage of each case ``(cfg, splits, n_layers, stacked,
    x, r)``: the forward output, and the loss sum(out * r) with this rank's
    block gradient and (rank 0) the gradient of x. Ranks other than 0 get x
    as NaNs: they may read only its shape and dtype. Also returns this
    rank's stage calls in order, with their layer counts."""
    out = []
    for cfg, splits, n_layers, stacked, x, r in cases:
        p = plan(splits, x.shape[0], x.shape[1])
        ex = DistributedPipelineExecutor(p, n_layers, layer_fn(cfg))
        block = stage_block(stacked, PipelineSpec.from_plan(p, n_layers), rank)
        calls, stage_fn, stage_grad = [], ex._stage_fn, ex._stage_grad

        def traced(x_in, layers, kept=None, stage_fn=stage_fn, calls=calls):
            calls.append(("forward", len(layers)))
            return stage_fn(x_in, layers, kept)

        def traced_grad(kept, layers, g, stage_grad=stage_grad, calls=calls):
            calls.append(("backward", len(layers), len(kept)))
            return stage_grad(kept, layers, g)
        ex._stage_fn, ex._stage_grad = traced, traced_grad
        x_here = x if rank == 0 else torch.full_like(x, float("nan"))
        y = ex.forward(block, x_here)
        loss, grads, grad_x = ex.loss_and_grads(block, x_here, lambda o, r=r: (o * r).sum())
        out.append(dict(out=y, loss=loss, grads=grads, grad_x=grad_x, calls=calls))
    return out


def failing_rank(rank, world, how):
    """``how == "raise"``: rank 1 raises while rank 0 waits in ``recv`` for
    it; ``"hang"``: every rank sleeps past any test's timeout."""
    if how == "hang":
        time.sleep(600)
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    buf = torch.empty(4)
    dist.recv(buf, 1)
    return buf
