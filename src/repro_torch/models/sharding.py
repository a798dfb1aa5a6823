"""Parameter / cache / batch sharding rules for the production meshes
(PyTorch counterpart of ``repro.models.sharding``, rule for rule).

Baseline ("megatron+fsdp") layout — the hybrid-parallel plan a Dora-style
planner emits for a homogeneous pod:

* batch over ``("pod","data")``;
* tensor parallelism over ``"model"``: attention heads (when divisible),
  MLP hidden dim, expert dim for MoE, recurrent width for RG-LRU;
* FSDP (ZeRO-3-style) over ``("pod","data")`` on a second weight dim;
* KV caches: batch-sharded; sequence dim over ``"model"`` (split-KV
  decode) when the batch axis can't cover the mesh.

Rules are *path-based* on the parameter tree (nested dicts, the JAX
package's layout and ``/``-joined key paths, stacked ``(n_units, ...)``
leaves under ``stack/``) so every family shares one rule set; non-divisible
dims fall back to replication. The specs are the port's ``P``;
``sharding_utils.placements`` turns them into DTensor placements. The rules
read only paths and shapes, so they also cover the families the port cannot
build yet (MoE, MLA, the encoder-decoder).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from .config import ArchConfig
from .sharding_utils import P, mesh_sizes

FSDP = ("pod", "data")
TP = "model"


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn("/"-joined key path, leaf)`` over nested dicts, lists and tuples
    (list and tuple entries keyed by their index, as JAX keys them)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


class ShardingRules:
    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        sizes = mesh_sizes(mesh)
        self.sizes = sizes
        self.tp = sizes.get("model", 1)
        self.fsdp = sizes.get("data", 1) * sizes.get("pod", 1)
        self.batch_axes = tuple(a for a in ("pod", "data") if a in sizes)

    # -- helpers ------------------------------------------------------------------
    def _p(self, *entries) -> P:
        """Build a spec, dropping axes absent from the mesh."""
        names = set(self.sizes)
        out = []
        for e in entries:
            if e is None:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a in names)
                out.append(kept if kept else None)
            else:
                out.append(e if e in names else None)
        return P(*out)

    def _fsdp_ok(self, dim: int) -> bool:
        return _div(dim, self.fsdp)

    def _tp_ok(self, dim: int) -> bool:
        return _div(dim, self.tp)

    # -- parameter rules ---------------------------------------------------------------
    def param_spec(self, path: str, shape) -> P:
        """path: '/'-joined key path (stacking detected by ndim vs rule arity)."""
        cfg = self.cfg
        nd = len(shape)
        leaf = path.split("/")[-1]

        def wrap(*entries):
            """Prepend None for the stacked layer dim when present."""
            spec = list(entries)
            while len(spec) < nd:
                spec.insert(0, None)
            if len(spec) > nd:
                spec = spec[-nd:]
            return self._p(*spec)

        fs = FSDP
        # embeddings / head
        if leaf in ("embed", "unembed"):
            v_dim, d_dim = (0, 1) if leaf == "embed" else (1, 0)
            spec = [None, None]
            if self._tp_ok(shape[v_dim]):
                spec[v_dim] = TP
            if self._fsdp_ok(shape[d_dim]):
                spec[d_dim] = fs
            return self._p(*spec)
        if leaf == "enc_pos":
            return wrap(None, None)
        # norms / scalars / gates
        if nd - self._stack_depth(path) <= 1 or leaf in (
                "ln1", "ln2", "ln_x", "ln_f", "ln_enc", "q_norm", "k_norm",
                "kv_norm", "norm_scale", "a_log", "dt_bias", "d_skip",
                "ba", "bx", "lam"):
            return self._p(*([None] * nd))
        # attention projections
        if leaf == "wq":
            h = shape[-2]
            return wrap(fs if self._fsdp_ok(shape[-3]) else None,
                        TP if self._tp_ok(h) else None, None)
        if leaf in ("wk", "wv"):
            kv = shape[-2]
            return wrap(fs if self._fsdp_ok(shape[-3]) else None,
                        TP if self._tp_ok(kv) else None, None)
        if leaf == "wo":
            h = shape[-3]
            return wrap(TP if self._tp_ok(h) else None, None,
                        fs if self._fsdp_ok(shape[-1]) else None)
        # MLA
        if leaf == "wq_a":
            return wrap(fs if self._fsdp_ok(shape[-2]) else None,
                        TP if self._tp_ok(shape[-1]) else None)
        if leaf == "wkv_a":
            return wrap(fs if self._fsdp_ok(shape[-2]) else None, None)
        if leaf in ("wq_nope", "wq_rope", "wk_nope"):
            return wrap(fs if self._fsdp_ok(shape[-3]) else None,
                        TP if self._tp_ok(shape[-2]) else None, None)
        # MoE
        if "moe" in path:
            if leaf == "router":
                # (d_model, E) f32 — stacked over layers this is hundreds
                # of MB; FSDP-shard the d_model dim
                return wrap(fs if self._fsdp_ok(shape[-2]) else None, None)
            if leaf in ("w_up", "w_gate") and nd - self._stack_depth(path) == 3:
                return wrap(TP if self._tp_ok(shape[-3]) else None,
                            fs if self._fsdp_ok(shape[-2]) else None, None)
            if leaf == "w_down" and nd - self._stack_depth(path) == 3:
                return wrap(TP if self._tp_ok(shape[-3]) else None, None,
                            fs if self._fsdp_ok(shape[-1]) else None)
        # wv in MLA context (Rkv, H, dv)
        if leaf == "wv" and cfg.mla:
            return wrap(fs if self._fsdp_ok(shape[-3]) else None,
                        TP if self._tp_ok(shape[-2]) else None, None)
        # dense MLP (also MoE shared expert)
        if leaf in ("w_up", "w_gate"):
            return wrap(fs if self._fsdp_ok(shape[-2]) else None,
                        TP if self._tp_ok(shape[-1]) else None)
        if leaf == "w_down":
            return wrap(TP if self._tp_ok(shape[-2]) else None,
                        fs if self._fsdp_ok(shape[-1]) else None)
        # Mamba2
        if leaf == "in_proj":
            return wrap(fs if self._fsdp_ok(shape[-2]) else None, None)
        if leaf == "out_proj":
            return wrap(TP if self._tp_ok(shape[-2]) else None,
                        fs if self._fsdp_ok(shape[-1]) else None)
        if leaf == "conv_w":
            return wrap(None, TP if self._tp_ok(shape[-1]) else None)
        # RG-LRU
        if leaf in ("w_in", "w_gate_branch"):
            return wrap(fs if self._fsdp_ok(shape[-2]) else None,
                        TP if self._tp_ok(shape[-1]) else None)
        if leaf in ("wa", "wx"):
            return wrap(fs if self._fsdp_ok(shape[-2]) else None,
                        TP if self._tp_ok(shape[-1]) else None)
        if leaf == "w_out":
            return wrap(TP if self._tp_ok(shape[-2]) else None,
                        fs if self._fsdp_ok(shape[-1]) else None)
        return self._p(*([None] * nd))

    def _stack_depth(self, path: str) -> int:
        """1 when the param lives under a stack ('stack/...')."""
        return 1 if path.startswith("stack/") or "/enc/" in path \
            or path.startswith("enc/") or path.startswith("dec/") else 0

    # -- trees --------------------------------------------------------------------------
    def param_specs(self, params_shape) -> Any:
        return map_with_path(lambda path, leaf: self.param_spec(path, leaf.shape), params_shape)

    def _batch_ok(self, global_batch: int) -> bool:
        dp = 1
        for a in self.batch_axes:
            dp *= self.sizes[a]
        return _div(global_batch, dp)

    def cache_specs(self, cache_shape, global_batch: int) -> Any:
        """KV/state caches: batch over (pod,data) when divisible; the
        cache sequence dim goes over 'model' (split-KV decode); for
        batch=1 long-context it takes every mesh axis instead."""
        batch_ok = self._batch_ok(global_batch)

        def fn(path: str, leaf):
            name = path.split("/")[-1]
            shape = leaf.shape
            nd = len(shape)
            stacked = 1 if any(path.startswith(s) for s in
                               ("stack", "self", "cross")) else 0
            spec: list = [None] * nd
            b_idx = stacked            # (L, B, ...) or (B, ...)
            if nd > b_idx and batch_ok and shape[b_idx] == global_batch:
                spec[b_idx] = FSDP
            # sequence dim of attention caches: (L?, B, T, KV, hd) / (L?, B, T, R)
            t_idx = b_idx + 1
            if name in ("k", "v", "ckv", "krope") and nd >= t_idx + 2:
                if not batch_ok and _div(shape[t_idx], self.fsdp * self.tp):
                    spec[t_idx] = tuple(self.batch_axes) + (TP,)
                elif self._tp_ok(shape[t_idx]):
                    spec[t_idx] = TP
            return self._p(*spec)
        return map_with_path(fn, cache_shape)

    def batch_specs(self, batch_shape, global_batch: int) -> Any:
        batch_ok = self._batch_ok(global_batch)

        def fn(_path: str, leaf):
            nd = len(leaf.shape)
            spec: list = [None] * nd
            if batch_ok and nd >= 1 and leaf.shape[0] == global_batch:
                spec[0] = FSDP
            return self._p(*spec)
        return map_with_path(fn, batch_shape)


def train_state_specs(rules: ShardingRules, tree_shapes: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of a ``{"params", "opt": {"m", "v", "count"}}`` train state:
    the moments laid out like the parameters, the count replicated (the
    reference helpers' ``spec_fn``)."""
    return {"params": rules.param_specs(tree_shapes["params"]),
            "opt": {"m": rules.param_specs(tree_shapes["opt"]["m"]),
                    "v": rules.param_specs(tree_shapes["opt"]["v"]),
                    "count": P()}}
