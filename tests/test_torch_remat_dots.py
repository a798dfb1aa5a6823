"""``remat="dots"``: each stacked unit recomputed in the backward but for the
outputs of its products without batch dims, the counterpart of
``jax.checkpoint_dots_with_no_batch_dims`` (``models/transformer.py``,
``dots_policy``), and the encoder-decoder unrematted on any value but
"full", as the JAX package runs it.

* Gradients under "dots" equal "full"'s and ``jax.grad`` of the JAX
  package's ``remat="dots"`` loss: float32 within 2e-5 of each leaf's
  largest magnitude (the loss at 2e-5 relative), bfloat16 within a relative
  L2 error of 2e-2 a leaf, for a dense, an MoE, an MLA, a recurrent and an
  SSM arch and the encoder-decoder. Weights as ``tests/test_torch_train.py``
  makes them (the JAX init, wq and wk scaled by 0.3).
* What "dots" keeps for one unit: the multiset of the kept products' sizes
  equals the residuals ``jax.ad_checkpoint.print_saved_residuals`` lists for
  the reference's unit under its policy (every residual that is neither an
  argument nor a constant: the dot outputs, and where the reference's
  ``silu`` is a jitted function, its output in place of the gate product's,
  of the same size), plus the unit's last product where it is a 2-D one
  (an MLP's down projection; an MoE unit ends in the experts'): its output only feeds
  the residual add into the unit's output, which JAX's partial evaluation
  drops as a residual no backward reads, while torch's selective checkpoint
  keeps every product its policy saves.
* Every projection is a 2-D product (``aten.mm``): MLA's and the router's,
  rewritten from einsums that dispatched to ``aten.bmm`` with batch 1,
  equal those einsums within 1e-6.
"""
import contextlib
import dataclasses
import functools
import io
from collections import Counter

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import reduced_config as j_reduced
from repro.models.transformer import LM as JLM
from repro_torch.configs import reduced_config
from repro_torch.models import attention, build_model, mlp
from repro_torch.models import transformer as tr
from repro_torch.models.convert import from_numpy
from test_torch_encdec import _frames, _models
from test_torch_train import _batch, _grad_close, _walk, _weights

torch.set_num_threads(2)


def _leaves(params, weights):
    out = []
    _walk(params, weights, lambda t, _: out.append(t.requires_grad_(True)))
    return out


def _loss_and_grads(tm, params, leaves, batch, remat):
    loss, _ = tm.loss(params, batch, remat=remat)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,attn_chunk", [("qwen3_32b", 8), ("olmoe_1b_7b", 8),
                                             ("deepseek_v2_236b", 16),
                                             ("recurrentgemma_9b", 8), ("mamba2_780m", 64)])
def test_dots_gradients_match_full_and_jax(arch, attn_chunk):
    jm, weights = _weights(arch, attn_chunk=attn_chunk)
    tm = build_model(dataclasses.replace(reduced_config(arch), attn_chunk=attn_chunk),
                     device="cpu")
    batch = _batch(jm.cfg.vocab_size)

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, batch), remat="dots")
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, weights))

    params = from_numpy(weights, device="cpu")
    leaves = _leaves(params, weights)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _loss_and_grads(tm, params, leaves, tbatch, "dots")
    full_loss, full = _loss_and_grads(tm, params, leaves, tbatch, "full")

    assert float(loss.detach()) == pytest.approx(float(jl), rel=2e-5)
    assert float(loss.detach()) == pytest.approx(float(full_loss.detach()), rel=2e-5)
    it = iter(grads)
    _walk(params, jax.tree.map(np.asarray, jg), lambda t, j: _grad_close(next(it), j))
    for g, f in zip(grads, full):
        _grad_close(g, f.numpy())


def _rel_l2(a, b):
    a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_dots_gradients_in_bfloat16():
    arch = "qwen3_32b"
    jm, weights = _weights(arch, attn_chunk=8, dtype="bfloat16")
    tm = build_model(dataclasses.replace(reduced_config(arch), attn_chunk=8, dtype="bfloat16"),
                     device="cpu")
    batch = _batch(jm.cfg.vocab_size)

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, batch), remat="dots")[0]
    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, weights))
    params = from_numpy(weights, device="cpu")
    leaves = _leaves(params, weights)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = _loss_and_grads(tm, params, leaves, tbatch, "dots")
    _, full = _loss_and_grads(tm, params, leaves, tbatch, "full")
    it = iter(grads)

    def close(t, j):
        g = next(it)
        assert g.dtype == t.dtype
        assert _rel_l2(g, j) <= 2e-2
    _walk(params, jax.tree.map(lambda a: np.asarray(a, np.float32), jg), close)
    for g, f in zip(grads, full):
        assert _rel_l2(g, f.float().numpy()) <= 2e-2


def test_encoder_decoder_runs_dots_unrematted():
    """The JAX package's EncDecLM rematerialises on "full" alone, so "dots"
    is "none" there: the port's gradients equal "none"'s and jax.grad's."""
    jm, jparams, tm, tparams = _models()
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    frames = _frames(cfg)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
              "encoder_frames": jnp.asarray(frames)}
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jbatch, remat="dots"),
                                     has_aux=True)(jparams)
    weights = jax.tree.map(np.asarray, jparams)
    leaves = _leaves(tparams, weights)
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
              "encoder_frames": torch.from_numpy(frames)}
    loss, grads = _loss_and_grads(tm, tparams, leaves, tbatch, "dots")
    none_loss, none = _loss_and_grads(tm, tparams, leaves, tbatch, "none")
    assert float(loss.detach()) == pytest.approx(float(jl), rel=2e-5)
    assert float(loss.detach()) == float(none_loss.detach())
    it = iter(grads)
    _walk(tparams, jax.tree.map(np.asarray, jg), lambda t, j: _grad_close(next(it), j))
    for g, n in zip(grads, none):
        torch.testing.assert_close(g, n, rtol=0, atol=0)


def test_lm_refuses_an_unknown_remat():
    tm = build_model(reduced_config("qwen3_32b"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        tm.apply(params, torch.zeros((1, 4), dtype=torch.int32), remat="bogus")


# -- what "dots" keeps ----------------------------------------------------------------
def _jax_saved(arch, S):
    """Sizes of the non-argument, non-constant residuals of the reference's
    unit under its "dots" policy."""
    cfg = dataclasses.replace(j_reduced(arch), dtype="float32", attn_chunk=64)
    m = JLM(cfg)
    params = m.init(jax.random.PRNGKey(0))
    unit = m.scan_groups()[0]
    up = jax.tree.map(lambda t: t[0], params["stack"])
    f = jax.remat(functools.partial(JLM._unit_apply, cfg=cfg, unit=unit, prefix_len=0),
                  policy=jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims)
    x = jnp.zeros((2, S, cfg.d_model), jnp.float32)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(lambda x, p: f(x, p)[0].sum(), x, up)
    sizes = []
    for line in buf.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line or "[" not in line:
            continue
        dims = line.split("[", 1)[1].split("]", 1)[0]
        sizes.append(int(np.prod([int(d) for d in dims.split(",") if d])))
    return sizes


@pytest.mark.parametrize("arch", ["qwen3_32b", "granite_20b", "olmoe_1b_7b",
                                  "deepseek_v2_236b", "recurrentgemma_9b", "mamba2_780m"])
def test_dots_keeps_the_reference_products(monkeypatch, arch):
    S = 32
    kept, products = [], []
    policy = tr.dots_policy

    def recording(ctx, func, *args, **kwargs):
        out = policy(ctx, func, *args, **kwargs)
        if not ctx.is_recompute and func in (torch.ops.aten.mm.default,
                                             torch.ops.aten.bmm.default):
            products.append(func)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(args[-2].shape[0] * args[-1].shape[1])
        return out
    monkeypatch.setattr(tr, "dots_policy", recording)
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32", attn_chunk=64)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, S, cfg.d_model, requires_grad=True)
    y, aux = tr.rematted(m._unit_apply, "dots")(x, tr._layer(params["stack"], 0), 0)
    (y.sum() + aux).backward()
    if products[-1] == torch.ops.aten.mm.default:     # the unit's last product
        kept = kept[:-1]
    assert Counter(kept) == Counter(_jax_saved(arch, S))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_projections_are_two_d_products():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 7, 24, generator=g), torch.randn(24, 4, 8, generator=g)
    with _Ops() as ops:
        got = attention.heads_in(x, w)
    assert torch.ops.aten.mm.default in ops.seen and torch.ops.aten.bmm.default not in ops.seen
    torch.testing.assert_close(got, torch.einsum("bsd,dhk->bshk", x, w), rtol=1e-6, atol=1e-6)

    cfg = reduced_config("olmoe_1b_7b")
    xg = torch.randn(4, 8, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    with _Ops() as ops:
        eidx, gate, dest, me, ce = mlp._route_local(xg, router, cfg, C=8)
    assert torch.ops.aten.bmm.default not in ops.seen
    probs = torch.softmax(torch.einsum("gtd,de->gte", xg, router).float(), dim=-1)
    torch.testing.assert_close(me[0], probs.mean(dim=(0, 1)), rtol=1e-6, atol=1e-6)
