"""Step builders (PyTorch counterpart of ``repro.launch.steps``):
``make_train_step`` (loss, gradients, AdamW), and the serving steps
``make_prefill_step`` / ``make_serve_step`` (greedy argmax to int32 tokens
of shape (B, 1)).

The modality frontends are stubs, as in the JAX package: whisper takes
precomputed frame embeddings (``encoder_frames``, (B, enc_seq, d_model)),
paligemma precomputed patch embeddings (``extra_embeddings``, (B,
n_patches, d_model)), in the training batch and in the prefill step's
``extras``.

The step structs (``param_structs``, ``batch_structs``, ``serve_structs``,
``step_struct``; the reference's ``ShapeDtypeStruct`` builders) make the
steps' arguments for a dry-run: FakeTensor DTensors laid out by
``ShardingRules`` on a mesh, each rank holding only its own shard, made
under the caller's active ``FakeTensorMode`` (they refuse to run without
one: a real tensor of a production shape would not fit)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import Model, build_model
from ..models.common import dtype_of
from ..models.config import ArchConfig
from ..models.sharding import ShardingRules
from ..models.sharding_utils import (distribute_tree, is_dtensor, relayout, rows_of, summed,
                                     zeros_on_mesh)
from ..optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
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
    shapes = _stub_shapes(cfg, batch)
    dtype = dtype_of(cfg.dtype)
    if gen is None:
        stubs = {k: torch.zeros(s, dtype=dtype, device=device) for k, s in shapes.items()}
    else:
        stubs = {k: (torch.randn(s, generator=gen, device=device) * 0.02).to(dtype)
                 for k, s in shapes.items()}
    if mesh is None or not stubs:
        return stubs
    return distribute_tree(stubs, ShardingRules(cfg, mesh).batch_specs(stubs, batch), mesh)


def _stub_shapes(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """The shape of each frontend stub ``cfg``'s model takes."""
    shapes = {}
    if cfg.encdec:
        shapes["encoder_frames"] = (batch, cfg.enc_seq, cfg.d_model)
    if cfg.vision_stub:
        shapes["extra_embeddings"] = (batch, cfg.n_patches, cfg.d_model)
    return shapes


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


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax token of each row's logits (B, 1, V) -> (B, 1) int32; under
    a mesh the vocabulary is gathered first, each rank keeping its batch
    rows."""
    if is_dtensor(logits):
        logits = relayout(summed(logits), rows_of(logits))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def prefill_step(params, tokens, cache, extras=None):
        """``extras``: {"encoder_frames": ...} for the encoder-decoder,
        {"extra_embeddings": ...} for the VLM; other models ignore it."""
        logits, cache = prefill_logits(model, params, tokens, cache, extras)
        return greedy(logits), cache

    return model, prefill_step


def make_serve_step(cfg: ArchConfig, device="cuda") -> Tuple[Model, Callable]:
    model = build_model(cfg, device=device)

    @torch.no_grad()
    def serve_step(params, token, cache, pos):
        logits, cache = model.decode(params, token, cache, pos)
        return greedy(logits), cache

    return model, serve_step


# ==================================================================================
# step structs: the steps' arguments as FakeTensor DTensors on a mesh
# ==================================================================================
def _require_fake_mode() -> None:
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("the step structs are FakeTensors: call them under an active "
                           "torch._subclasses.fake_tensor.FakeTensorMode")


def _shards(shapes: Any, specs: Any, mesh, device) -> Any:
    """``shapes`` (a tree of tensors; only shapes and dtypes are read) as
    DTensors laid out by ``specs``, each rank allocating its own shard."""
    return tree_map(lambda t, spec: zeros_on_mesh(t.shape, t.dtype, spec, mesh, device),
                    shapes, specs)


def param_structs(cfg: ArchConfig, mesh, device) -> Tuple[Any, Any]:
    """(params, AdamW state) with the init's tree layout, laid out by
    ``ShardingRules.param_specs``; the moments as the parameters, the count
    a plain 0-d int32 (replicated: the same on every rank). The shapes come
    from the init run on fake CPU tensors."""
    _require_fake_mode()
    shapes = build_model(cfg, device="cpu").init(torch.Generator())
    params = _shards(shapes, ShardingRules(cfg, mesh).param_specs(shapes), mesh, device)
    return params, adamw_init(params)


def batch_structs(cfg: ArchConfig, shape, mesh, device) -> Dict[str, Any]:
    """The training batch of ``shape`` (a ``configs.ShapeSpec``): tokens and
    labels (B, S) int32 and the frontend stub the model takes, laid out by
    ``ShardingRules.batch_specs``."""
    _require_fake_mode()
    B, S = shape.global_batch, shape.seq_len
    tree = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "labels": torch.empty((B, S), dtype=torch.int32, device="meta"),
            **_stub_structs(cfg, B)}
    return _shards(tree, ShardingRules(cfg, mesh).batch_specs(tree, B), mesh, device)


def _stub_structs(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    dtype = dtype_of(cfg.dtype)
    return {k: torch.empty(s, dtype=dtype, device="meta")
            for k, s in _stub_shapes(cfg, batch).items()}


def serve_structs(cfg: ArchConfig, shape, mesh, device) -> Dict[str, Any]:
    """The serving step's arguments for ``shape``: the cache of
    ``shape.seq_len`` positions, and the prompt ``tokens`` (B, S) with the
    frontend stubs under ``extras`` (prefill) or one ``token`` (B, 1) and
    ``pos`` (B,) (decode), int32, laid out by ``serve_specs``."""
    _require_fake_mode()
    B, S = shape.global_batch, shape.seq_len
    model = build_model(cfg, device="meta")
    tree: Dict[str, Any] = {"cache": model.init_cache(B, S)}
    if shape.mode == "prefill":
        tree["tokens"] = torch.empty((B, S), dtype=torch.int32, device="meta")
        tree["extras"] = _stub_structs(cfg, B)
    else:
        tree["token"] = torch.empty((B, 1), dtype=torch.int32, device="meta")
        tree["pos"] = torch.empty((B,), dtype=torch.int32, device="meta")
    return _shards(tree, serve_specs(cfg, mesh, tree, B), mesh, device)


def step_struct(mesh, device) -> torch.Tensor:
    """The train step's ``step``: a 0-d int32, replicated (a plain tensor,
    the same on every rank, as the trainer's count is)."""
    _require_fake_mode()
    return torch.zeros((), dtype=torch.int32, device=device)
