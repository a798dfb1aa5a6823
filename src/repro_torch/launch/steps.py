"""Step builders (PyTorch counterpart of ``repro.launch.steps``):
``make_train_step`` (loss, gradients, AdamW), and the serving steps
``make_prefill_step`` / ``make_serve_step`` (greedy argmax to int32 tokens
of shape (B, 1)).

The modality frontends are stubs, as in the JAX package: whisper takes
precomputed frame embeddings (``encoder_frames``, (B, enc_seq, d_model)),
paligemma precomputed patch embeddings (``extra_embeddings``, (B,
n_patches, d_model)), in the training batch and in the prefill step's
``extras``."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models import Model, build_model
from ..models.common import dtype_of
from ..models.config import ArchConfig
from ..models.sharding import ShardingRules
from ..models.sharding_utils import distribute_tree, is_dtensor, zeros_on_mesh
from ..optim import AdamWConfig, adamw_update, warmup_cosine
from ..optim.adamw import tree_leaves, tree_map


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor (differentiable), else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def frontend_stubs(cfg: ArchConfig, batch: int, device,
                   gen: Optional[torch.Generator] = None, mesh=None) -> Dict[str, torch.Tensor]:
    """The frontend stub ``cfg``'s model takes, in its dtype: whisper's
    frames {"encoder_frames": (batch, enc_seq, d_model)}, paligemma's
    patches {"extra_embeddings": (batch, n_patches, d_model)}, {} for the
    others. Zeros, as the JAX launchers feed them, or N(0, 0.02^2) drawn
    from ``gen`` (on ``device``; the same draw on every rank). Under a
    device ``mesh`` they are DTensors laid out by
    ``ShardingRules.batch_specs``, as the reference's ``batch_structs``
    lays them out."""
    shapes = {}
    if cfg.encdec:
        shapes["encoder_frames"] = (batch, cfg.enc_seq, cfg.d_model)
    if cfg.vision_stub:
        shapes["extra_embeddings"] = (batch, cfg.n_patches, cfg.d_model)
    dtype = dtype_of(cfg.dtype)
    if gen is None:
        stubs = {k: torch.zeros(s, dtype=dtype, device=device) for k, s in shapes.items()}
    else:
        stubs = {k: (torch.randn(s, generator=gen, device=device) * 0.02).to(dtype)
                 for k, s in shapes.items()}
    if mesh is None or not stubs:
        return stubs
    return distribute_tree(stubs, ShardingRules(cfg, mesh).batch_specs(stubs, batch), mesh)


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, remat: str = "full", opt: AdamWConfig = AdamWConfig(),
                    device="cuda") -> Tuple[Model, Callable]:
    """``train_step(params, opt_state, batch, step)`` →
    ``(params, opt_state, {"loss", "lr", "nll", "aux", "grad_norm", "clip_scale"})``.
    ``batch`` holds ``tokens`` and ``labels`` (B, S), and the frontend stub
    its model takes, which ``model.loss`` reads from it.

    The gradients of ``model.loss`` come from autograd (the flash kernel's
    backward on the card); AdamW then updates ``params`` and the moments in
    place (``optim.adamw``). The metrics stay 0-d tensors (``lr`` on
    ``step``'s device, the CPU for a Python int): a step never waits on the
    card. Under a device mesh ``params``, the moments and the batch are
    DTensors (``launch.train``); the loss and metrics come back as plain
    tensors, the same on every rank."""
    model = build_model(cfg, device=device)

    def train_step(params, opt_state, batch, step):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch, remat=remat)
        loss = _plain(loss)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        lr = warmup_cosine(step, peak_lr=peak_lr, warmup=warmup, total=total)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr, opt)
        out = {"loss": loss.detach(), "lr": lr,
               **{k: _plain(v.detach()) for k, v in metrics.items()}, **om}
        return params, opt_state, out

    return model, train_step


def serve_specs(cfg: ArchConfig, mesh, tree: Dict, global_batch: int) -> Dict:
    """The specs of real serving tensors on ``mesh``, as the reference's
    ``serve_structs`` lays them out: ``tree["cache"]`` by
    ``ShardingRules.cache_specs``, every other entry (the prompt ``tokens``
    or the ``token`` of a step, ``pos``, the frontend stubs under ``extras``)
    by ``ShardingRules.batch_specs``."""
    rules = ShardingRules(cfg, mesh)
    return {k: (rules.cache_specs if k == "cache" else rules.batch_specs)(v, global_batch)
            for k, v in tree.items()}


def lay_out_serving(cfg: ArchConfig, mesh, tree: Dict, global_batch: int) -> Dict:
    """``tree`` (see ``serve_specs``; the same full tensors on every rank)
    as DTensors laid out by ``serve_specs``, with no communication."""
    return distribute_tree(tree, serve_specs(cfg, mesh, tree, global_batch), mesh)


def init_serving_cache(model: Model, batch: int, max_len: int, mesh=None) -> Dict:
    """``model.init_cache(batch, max_len)``; under ``mesh`` as DTensors laid
    out by ``ShardingRules.cache_specs``, each rank allocating only its own
    shard (``zeros_on_mesh``)."""
    if mesh is None:
        return model.init_cache(batch, max_len)
    shapes = type(model)(model.cfg, device="meta").init_cache(batch, max_len)
    specs = ShardingRules(model.cfg, mesh).cache_specs(shapes, batch)
    return tree_map(lambda t, spec: zeros_on_mesh(t.shape, t.dtype, spec, mesh, model.device),
                    shapes, specs)


def prefill_logits(model: Model, params, tokens, cache, extras=None):
    """``model.prefill`` with the frontend stub its model takes from
    ``extras`` ({"encoder_frames": ...} for the encoder-decoder,
    {"extra_embeddings": ...} for the VLM; other models ignore it):
    (the last position's logits, cache)."""
    extras = extras or {}
    cfg = model.cfg
    if cfg.encdec:
        return model.prefill(params, tokens, cache, encoder_frames=extras["encoder_frames"])
    if cfg.vision_stub:
        return model.prefill(params, tokens, cache, extra_embeddings=extras["extra_embeddings"])
    return model.prefill(params, tokens, cache)


def make_prefill_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def prefill_step(params, tokens, cache, extras=None):
        """``extras``: {"encoder_frames": ...} for the encoder-decoder,
        {"extra_embeddings": ...} for the VLM; other models ignore it."""
        logits, cache = prefill_logits(model, params, tokens, cache, extras)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return model, prefill_step


def make_serve_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def serve_step(params, token, cache, pos):
        logits, cache = model.decode(params, token, cache, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return model, serve_step
