"""The port's three examples (``examples/*_torch.py``) against their JAX
twins, on the CPU.

- Smart home: the plan's summary equals the one the JAX example plans for
  the same arguments; 20 training steps lower the loss; a second run on the
  same checkpoint directory resumes at step 20.
- Traffic monitor: the dynamics trace's summary equals ``repro.dora
  .simulate``'s over the JAX example's timeline (both planning stacks read
  one ticking clock, ``torch_parity.use_clock``); the greedy tokens of the
  port's decode loop equal the JAX model's from the same weights.
- Elastic recovery: 4 gloo ranks, half of them fail, the survivors regroup
  onto a (1, 2) mesh, restore and take a finite step; the replanned stage
  count equals the JAX package's plan of the same survivors' scenario.
"""
import dataclasses
import importlib
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dora as jdora
from repro.configs import reduced_config as j_reduced
from repro.core.cost_model import Workload as JWorkload
from repro.core.device import CATALOG as JCATALOG, Topology as JTopology
from repro.core.graph_builders import GraphSpec as JGraphSpec, build_lm_graph as jbuild_lm_graph
from repro.core.qoe import QoESpec as JQoESpec
from repro.models.transformer import LM as JLM
from repro.scenarios import Scenario as JScenario
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models.convert import from_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "examples"))
from torch_parity import use_clock  # noqa: E402

torch.set_num_threads(2)


def _example(name):
    return importlib.import_module(name)


def test_smart_home_plans_as_jax_trains_and_resumes(tmp_path, monkeypatch):
    ex, jex = _example("smart_home_training_torch"), _example("smart_home_training")
    clock = use_clock(monkeypatch, "repro", "repro_torch")
    jcfg = jex.model_cfg(False)
    spec = JGraphSpec("home-lm", jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                      jcfg.d_ff, jcfg.vocab_size, head_dim=jcfg.head_dim, seq_len=64)
    want = jdora.plan("smart_home_2", graph=jbuild_lm_graph(spec),
                      qoe=JQoESpec(t_qoe=2.0, lam=10.0),
                      workload=JWorkload(global_batch=32, microbatch_size=4, optimizer_mult=3.0))
    clock.reset()
    ckpt = str(tmp_path / "ckpt")
    before = launch_counts()
    out = ex.main(["--device", "cpu", "--steps", "20", "--seq", "64", "--ckpt-dir", ckpt])
    assert launch_counts() == before
    assert out["plan"].best.summary() == want.best.summary()
    assert out["plan"].best.n_stages == want.best.n_stages
    assert out["step0"] == 0 and len(out["losses"]) == 20
    assert all(math.isfinite(x) for x in out["losses"]) and out["final"] < out["first"]
    again = ex.main(["--device", "cpu", "--steps", "24", "--seq", "64", "--ckpt-dir", ckpt])
    assert again["step0"] == 20 and len(again["losses"]) == 4
    assert again["opt_count"] == 24


def test_traffic_monitor_traces_and_decodes_as_jax(monkeypatch):
    ex, jex = _example("traffic_monitor_serving_torch"), _example("traffic_monitor_serving")
    clock = use_clock(monkeypatch, "repro", "repro_torch")
    want = jdora.simulate("traffic_monitor", events=jex.TIMELINE)
    clock.reset()
    got = ex.dora.simulate("traffic_monitor", events=ex.TIMELINE)
    assert [label for label, _ in ex.TIMELINE] == [label for label, _ in jex.TIMELINE]
    assert got.summary() == want.summary()
    assert got.report.best.summary() == want.report.best.summary()

    # the greedy decode loop from the JAX package's weights, as the JAX example runs it
    jcfg = j_reduced("qwen3_32b")
    jm = JLM(jcfg)
    weights = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (ex.B, ex.PROMPT)).astype(
        np.int32)
    jp = jax.tree.map(jnp.asarray, weights)
    cache = jm.init_cache(ex.B, ex.PROMPT + ex.GEN)
    logits, cache = jm.prefill(jp, jnp.asarray(toks), cache)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    jtokens = [np.asarray(cur)]
    decode = jax.jit(jm.decode)
    for i in range(ex.GEN):
        logits, cache = decode(jp, cur, cache, jnp.full((ex.B,), ex.PROMPT + i, jnp.int32))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        jtokens.append(np.asarray(cur))

    model = build_model(ex.reduced_config("qwen3_32b"), device="cpu")
    before = launch_counts()
    tokens, _ = ex.greedy(model, from_numpy(weights, device="cpu"), torch.from_numpy(toks),
                          ex.GEN)
    assert launch_counts() == before
    assert tokens.dtype == torch.int32 and tokens.shape == (ex.B, 1 + ex.GEN)
    np.testing.assert_array_equal(tokens.numpy(), np.concatenate(jtokens, axis=1))


def test_traffic_monitor_main_runs_on_cpu():
    out = _example("traffic_monitor_serving_torch").main(["--device", "cpu"])
    assert out["tokens"].shape == (4, 33) and out["decode_steps"] == 33
    assert out["trace"].qoe_violations == 0


def test_elastic_recovery_four_gloo_ranks_to_two():
    ex = _example("elastic_recovery_torch")
    out = ex.main(["--device", "cpu", "--ranks", "4"])
    assert out["failed"] == [2, 3]
    assert out["world"] == 2 and out["generation"] == 1 and out["step"] == 4
    assert len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"])
    assert math.isfinite(out["resumed_loss"])

    # the JAX package's plan of the same survivors (the JAX example's Scenario at n = 2)
    cfg = ex.model_cfg()
    devs = [JCATALOG["rtx4050"]] * 2
    spec = JGraphSpec("m", cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                      cfg.vocab_size, seq_len=16)
    survivors = JScenario(
        name="home_survivors", description="Smart-home fleet after losing 2 of 4 devices",
        topology=lambda: JTopology.shared_medium(devs, 600.0),
        model=lambda seq_len: jbuild_lm_graph(spec, seq_len=seq_len),
        workload=JWorkload(global_batch=8, microbatch_size=1, optimizer_mult=3.0),
        qoe=JQoESpec(t_qoe=1.0, lam=10.0), seq_len=16)
    assert out["n_stages"] == jdora.plan(survivors).result.best.n_stages
    jcfg = dataclasses.replace(j_reduced("granite_8b"), n_layers=2, d_model=64, d_ff=128,
                               vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=16)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size) \
        == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_ff,
            jcfg.vocab_size)


def test_elastic_recovery_refuses_cuda_without_cards(monkeypatch):
    """With --device cuda and fewer cards than ranks it exits non-zero and
    says so, never falling back to the CPU."""
    ex = _example("elastic_recovery_torch")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="need a card each, 0 visible"):
        ex.main(["--device", "cuda", "--ranks", "4"])
