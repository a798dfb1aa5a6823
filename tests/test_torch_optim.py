"""The port's optimizer, LR schedule, data pipeline and checkpointer
(repro_torch.optim / .data / .checkpoint) against the JAX package's.

Inputs come from a numpy seed and reach both packages as the same numbers.
Tolerances: the schedule at 1e-6 relative, float32 AdamW state and
parameters at 1e-6 relative plus 1e-6 of the leaf's largest magnitude
(float32 arithmetic in the same order; the global norm sums in another
order, so the clip scale may differ in its last bit, and a moment where
0.9 m and 0.1 g nearly cancel carries that to a few 1e-6 of itself); bfloat16 parameters within one bf16 ulp (the new
value is computed in float32 and rounded once, so a last-bit difference of
the float32 value can move the rounding by one step); the token stream and
checkpoints bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data import DataConfig as JDataConfig, synthetic_stream as jsynthetic_stream
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update, warmup_cosine as jwarmup_cosine
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.data import DataConfig, TokenPipeline, synthetic_stream
from repro_torch.models.convert import from_numpy
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine

# two CPU threads each: the suite runs test files side by side in workers
torch.set_num_threads(2)


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("as_tensor", [False, True])
def test_warmup_cosine_matches_jax(as_tensor):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    for step in range(121):
        got = warmup_cosine(torch.tensor(step) if as_tensor else step, **kw)
        exp = float(jwarmup_cosine(jnp.asarray(step), **kw))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert float(got) == pytest.approx(exp, rel=1e-6, abs=1e-12), step


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup=10, total=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6           # warmup rises
    assert max(lrs) <= 1.0 + 1e-6                  # peak at warmup end
    assert abs(lrs.index(max(lrs)) - 10) <= 1
    assert lrs[-1] < 0.2                           # decays


# ---------------------------------------------------------------- AdamW
def _tree(rng, scale=1.0):
    """A parameter-shaped tree: a matrix, a vector and a stacked vector
    (ndim 2: decayed, as in the JAX package)."""
    return {"w": rng.standard_normal((8, 16)).astype(np.float32) * scale,
            "b": rng.standard_normal((16,)).astype(np.float32) * scale,
            "stack": {"u0": {"ln": rng.standard_normal((3, 16)).astype(np.float32) * scale}}}


def _bits(x):
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).view(np.int16)
    return a.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no-clip", "clip"])
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_adamw_update_matches_jax(dtype, grad_scale, lr_kind):
    rng = np.random.default_rng(0)
    params_np = _tree(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jopt, topt = jadamw_init(jparams), adamw_init(tparams)
    jcfg, tcfg = JAdamWConfig(), AdamWConfig()
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(rng, grad_scale))
        tg = from_numpy(jax.tree.map(np.asarray, g), device="cpu")
        if lr_kind == "float":
            jlr = tlr = 1e-2
        else:
            jlr = jwarmup_cosine(jnp.asarray(step + 1), peak_lr=1e-2, warmup=2, total=10)
            tlr = warmup_cosine(step + 1, peak_lr=1e-2, warmup=2, total=10)
        jparams, jopt, jm = jadamw_update(g, jopt, jparams, jlr, jcfg)
        tparams, topt, tm = adamw_update(tg, topt, tparams, tlr, tcfg)
        clipped = float(jm["clip_scale"]) < 1.0
        assert clipped == (grad_scale > 1.0)
        for key in ("grad_norm", "clip_scale"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
        assert int(topt["count"]) == int(jopt["count"]) == step + 1
        for name in ("m", "v"):
            for t, j in zip(_flat(topt[name]), _flat(jopt[name])):
                _close_f32(t, j)
        for t, j in zip(_flat(tparams), _flat(jparams)):
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            if dtype == "bfloat16":
                assert np.abs(_bits(t) - _bits(j)).max() <= 1      # one bf16 ulp
            else:
                _close_f32(t, j)


def _close_f32(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6 * float(np.abs(j).max()))


def _flat(tree):
    """Leaves in sorted-key order (JAX's order), for pairing the two trees."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_adamw_minimizes_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    for _ in range(300):
        g = {"x": 2.0 * params["x"]}
        params, opt, _ = adamw_update(g, opt, params, 0.05, cfg)
    assert float(torch.sum(params["x"] ** 2)) < 1e-3


def test_adamw_grad_clipping():
    params = {"x": torch.ones((4,))}
    opt = adamw_init(params)
    g = {"x": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(g, opt, params, 1e-3, AdamWConfig(clip_norm=1.0))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(metrics["clip_scale"]) == pytest.approx(1.0 / 200.0)
    assert float(global_norm(g)) == pytest.approx(200.0)


def test_adamw_state_converts_from_jax():
    """The JAX package's optimizer state reaches the port through numpy."""
    jparams = jax.tree.map(jnp.asarray, _tree(np.random.default_rng(1)))
    jopt = jadamw_init(jparams)
    jopt = {**jopt, "count": jnp.asarray(7, jnp.int32)}
    topt = from_numpy(jax.tree.map(np.asarray, jopt), device="cpu")
    assert topt["count"].dtype == torch.int32 and topt["count"].ndim == 0
    assert int(topt["count"]) == 7
    assert topt["m"]["stack"]["u0"]["ln"].dtype == torch.float32
    assert tuple(topt["v"]["w"].shape) == (8, 16)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 4, 7), (151936, 24, 2, 0)])
def test_synthetic_stream_matches_jax(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    t, j = synthetic_stream(DataConfig(**kw)), jsynthetic_stream(JDataConfig(**kw))
    for _ in range(3):
        a, b = next(t), next(j)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_synthetic_stream_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    a = next(synthetic_stream(cfg))
    b = next(synthetic_stream(cfg))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 17)
    assert a.min() >= 0 and a.max() < 100


def test_token_pipeline_shapes():
    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=8, global_batch=2), device="cpu")
    batch = next(pipe)
    assert batch["tokens"].shape == (2, 8) and batch["labels"].shape == (2, 8)
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].device.type == "cpu"
    assert next(pipe)["tokens"].shape == (2, 8)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_pipeline_labels_are_shifted():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=3)
    raw = next(synthetic_stream(cfg))
    pipe = TokenPipeline(cfg, device="cpu")
    batch = next(pipe)
    np.testing.assert_array_equal(batch["tokens"].numpy(), raw[:, :-1])
    np.testing.assert_array_equal(batch["labels"].numpy(), raw[:, 1:])
    pipe.close()


# ---------------------------------------------------------------- checkpoint
def _ctree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((16, 8), generator=g),
                       "b": torch.randn((8,), generator=g).to(torch.bfloat16)},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    tree = _ctree()
    ckpt.save(7, tree, wait=True)
    assert latest_step(str(tmp_path)) == 7
    meta = {k: {n: torch.empty_like(t, device="meta") for n, t in v.items()}
            for k, v in tree.items()}
    out = ckpt.restore(7, meta)
    _assert_tree_equal(out, tree)


def test_async_save_then_restore(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    tree = _ctree(1)
    saved = tree["params"]["w"].clone()
    ckpt.save(1, tree)
    tree["params"]["w"].add_(1.0)         # in-place updates after save do not reach it
    ckpt.wait()
    assert latest_step(str(tmp_path)) == 1
    out = ckpt.restore(1, tree)
    assert torch.equal(out["params"]["w"], saved)


def test_uncommitted_checkpoint_invisible(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(5, _ctree(), wait=True)
    os.makedirs(tmp_path / "step_000009")
    (tmp_path / "step_000009" / "MANIFEST.json").write_text("{}")
    assert latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(9, _ctree())


def test_gc_keeps_last_k(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _ctree(), wait=True)
    remaining = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert remaining == ["step_000003", "step_000004"]


def test_restore_to_another_dtype(tmp_path):
    """A target of another dtype gets the saved values cast to it; a meta
    target (shape and type only) restores to the CPU."""
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    tree = _ctree(2)
    ckpt.save(1, tree, wait=True)
    target = {"params": {"w": torch.empty((16, 8), dtype=torch.bfloat16, device="meta"),
                         "b": torch.empty((8,), dtype=torch.float32)},
              "opt": {"count": torch.empty((), dtype=torch.int64)}}
    out = ckpt.restore(1, target)
    assert out["params"]["w"].dtype == torch.bfloat16 and out["params"]["w"].device.type == "cpu"
    assert torch.equal(out["params"]["w"], tree["params"]["w"].to(torch.bfloat16))
    assert torch.equal(out["params"]["b"], tree["params"]["b"].float())
    assert out["opt"]["count"].dtype == torch.int64 and int(out["opt"]["count"]) == 3


def test_overwrite_same_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(1, _ctree(0), wait=True)
    t2 = _ctree(9)
    ckpt.save(1, t2, wait=True)
    out = ckpt.restore(1, t2)
    _assert_tree_equal(out, t2)


def test_jax_checkpoint_restores_bitwise(tmp_path):
    """A checkpoint the JAX package wrote (bf16, f32 and int32 leaves, nested
    dicts) restores in the port bit for bit, and the port's in JAX."""
    rng = np.random.default_rng(4)
    jtree = {"params": {"stack": {"u0": {"wq": jnp.asarray(rng.standard_normal((2, 8, 4)),
                                                           jnp.bfloat16)}},
                        "ln_f": jnp.asarray(rng.standard_normal((8,)), jnp.float32)},
             "opt": {"count": jnp.asarray(5, jnp.int32)}}
    JCheckpointer(str(tmp_path / "jax"), async_save=False).save(3, jtree, wait=True)
    target = from_numpy(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jtree), device="cpu")
    out = Checkpointer(str(tmp_path / "jax")).restore(3, target)
    exp = from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")
    _assert_tree_equal(out, exp)

    Checkpointer(str(tmp_path / "port"), async_save=False).save(4, exp, wait=True)
    back = JCheckpointer(str(tmp_path / "port")).restore(
        4, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
    assert np.asarray(back["params"]["stack"]["u0"]["wq"]).dtype == ml_dtypes.bfloat16
