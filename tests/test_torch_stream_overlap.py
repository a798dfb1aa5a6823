"""The DEFER streamed-migration pricing model against an executed pipeline
iteration, the port's twin of ``tests/helpers/stream_overlap_check.py``.

A streamed switch overlaps the next plan's weight transfer with the current
plan's ongoing execution; the span it can hide behind is a real forward
iteration. Here that iteration runs through ``DistributedPipelineExecutor``
with one gloo CPU rank a stage (4 stages of 2 tanh layers of width 16, 8
microbatches of 2), and the span it measures holds ``repro_torch.dora``'s
``adapter.switch_cost`` on hospital_ward to three things:

* zero overlap collapses to the synchronous cost (no free lunch),
* the executed span never prices above the synchronous switch,
* the exposed stall shrinks monotonically as the overlap grows and
  bottoms out at the drain.

It imports only ``repro_torch``, so it also runs on a machine without jax.
"""
import time

import torch
import torch.distributed as dist

from repro_torch import dora
from repro_torch.core import ParallelismPlan, Stage
from repro_torch.runtime.pipeline import DistributedPipelineExecutor, PipelineSpec, stage_block
from repro_torch.runtime.ranks import run_ranks

S, L, D = 4, 8, 16          # stages, layers, width
M, MB = 8, 2                # microbatches, microbatch size
REPS = 3


def _layer(lp, x):
    return torch.tanh(x @ lp["w"] + lp["b"])


def span_rank(rank, world):
    """Seconds of one executed forward iteration, the mean of ``REPS``
    after one warm-up, between barriers."""
    g = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn((L, D, D), generator=g) * 0.3, "b": torch.zeros((L, D))}
    x = torch.randn((M, MB, D), generator=g)
    plan = ParallelismPlan(stages=[Stage(node_ids=[2 * s, 2 * s + 1], devices=[s],
                                         microbatch_split={s: 1.0}) for s in range(S)],
                           microbatch_size=MB, n_microbatches=M)
    ex = DistributedPipelineExecutor(plan, L, _layer)
    block = stage_block(stacked, PipelineSpec.from_plan(plan, L), rank)
    ex.forward(block, x)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = ex.forward(block, x)
    dist.barrier()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    return (time.perf_counter() - t0) / REPS


def test_streamed_migration_model_vs_executed_pipeline_across_ranks():
    spans = run_ranks(span_rank, S, backend="gloo", timeout=120)
    span = max(spans)
    assert span > 0.0

    s = dora.serve("hospital_ward")
    cfg = s.adapter.config
    cfg.async_switching = False
    cfg.delta_switching = False
    old = s.current
    new = next(p for p in s.plans if len(p.devices) > 1)

    sync = s.adapter.switch_cost(old, new)
    assert sync > cfg.switch_drain_s, "need a real weight-load time"
    cfg.streamed_migration = True
    zero = s.adapter.switch_cost(old, new, overlap_s=0.0)
    assert abs(zero - sync) < 1e-9, (zero, sync)
    streamed = s.adapter.switch_cost(old, new, overlap_s=span)
    assert streamed <= sync + 1e-9, (streamed, sync)
    costs = [s.adapter.switch_cost(old, new, overlap_s=k * span)
             for k in range(0, 4000, 400)]
    assert all(a >= b - 1e-12 for a, b in zip(costs, costs[1:])), costs
    assert costs[-1] >= cfg.switch_drain_s - 1e-12
