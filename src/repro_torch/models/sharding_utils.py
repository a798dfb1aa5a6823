"""Sharding helpers usable both under a device mesh and on one device
(PyTorch counterpart of ``repro.models.sharding_utils``).

A ``torch.distributed`` ``DeviceMesh`` stands in for the JAX mesh, DTensor
placements for ``PartitionSpec``s and DTensor's sharding propagation for
GSPMD's. The port keeps the reference's specs: ``P`` is a tuple whose
entries are ``None``, a mesh axis name or a tuple of names (a one-name tuple
reads as the name and an empty one as ``None``, as ``PartitionSpec``
canonicalises them), and ``placements`` turns a spec into the DTensor
placements of a mesh. ``use_mesh`` (``launch/mesh.py``) sets the ambient
mesh that ``maybe_shard`` and ``mesh_axes`` read.

The JAX package's version shims (``abstract_mesh``'s jax 0.4 branch and
``launch/mesh.compat_make_mesh``) have no counterpart: there is one torch
API. ``abstract_mesh`` is kept as a device-free mesh for the sharding rules'
tests, which the reference builds on ``jax.sharding.AbstractMesh``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``, an axis name
    or a tuple of axis names (major to minor)."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else e[0] if len(e) == 1 else e
            out.append(e)
        return super().__new__(cls, out)

    def __getnewargs__(self):          # pickle through __new__(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# -- the ambient mesh (set by launch.mesh.use_mesh) ------------------------------
_MESHES: List[Any] = []


@contextlib.contextmanager
def ambient_mesh(mesh) -> Iterator[Any]:
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost ``use_mesh`` mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_axes() -> tuple:
    """Axis names of the ambient mesh (an empty tuple when unsharded)."""
    mesh = current_mesh()
    return () if mesh is None else tuple(mesh_sizes(mesh))


def clean_spec(spec: Sequence, shape: Sequence[int], sizes: Dict[str, int]) -> P:
    """``spec`` without the axes ``sizes`` lacks, and without a constraint
    whose axes' product does not divide its dim (batch=1 long-context), as
    the reference's ``maybe_shard`` cleans it."""
    cleaned = []
    for i, entry in enumerate(spec):
        if entry is None:
            cleaned.append(None)
            continue
        names = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        kept = tuple(a for a in names if a in sizes)
        total = 1
        for a in kept:
            total *= sizes[a]
        if not kept or (i < len(shape) and shape[i] % total != 0):
            cleaned.append(None)
        else:
            cleaned.append(kept)
    return P(*cleaned)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a cleaned ``spec`` on ``mesh``: a mesh dim named
    in the entry of tensor dim i shards i (``Shard(i)``; an entry of several
    names shards i over each, major to minor, as JAX lays it out), every
    other mesh dim replicates, and so does a mesh dim of one rank (its one
    shard is the whole tensor, but DTensor's view rules would still treat
    the dim as split)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    out: List[Any] = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {axes} is not in the mesh's order {names}: DTensor "
                             f"shards one tensor dim over mesh dims major to minor")
        for d in dims:
            if sizes[names[d]] > 1:
                out[d] = Shard(i)
    return tuple(out)


def is_dtensor(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor (plain tensors return before
    any import)."""
    if all(type(t) is torch.Tensor for t in tensors):
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def distribute(t: torch.Tensor, spec: Sequence, mesh):
    """``t`` (the full tensor, the same on every rank) as a DTensor laid out
    by ``spec`` on ``mesh``: each rank keeps a copy of its own slice (never a
    view of ``t``, which the caller may free or share), with no
    communication. ``t`` must lie on the mesh's device type: a tensor on
    another is refused, never moved (a card's parameters would otherwise
    land on the host)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if t.device.type != mesh.device_type:
        raise ValueError(f"distribute: a {t.device.type} tensor on a {mesh.device_type} mesh; "
                         "build the mesh on the rank's device (launch.mesh.make_mesh)")
    pl = placements(clean_spec(spec, t.shape, mesh_sizes(mesh)), mesh)
    local = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None).to_local()
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh, pl,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def zeros_on_mesh(shape: Sequence[int], dtype, spec: Sequence, mesh, device):
    """A DTensor of zeros of ``shape`` laid out by ``spec`` on ``mesh``, each
    rank allocating only its own shard on ``device`` (a serving cache too
    large to be made whole on every rank first)."""
    from torch.distributed.tensor import DTensor
    pl = placements(clean_spec(spec, shape, mesh_sizes(mesh)), mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(tuple(shape), device="meta").stride())


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """``distribute`` over nested dicts of tensors laid out like ``specs``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def summed(t):
    """The DTensor ``t`` with its pending sums (a projection whose
    contraction DTensor sharded) carried out: ``Partial()`` placements
    become ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def layer_view(t, i: int):
    """Layer ``i`` of a stacked DTensor (L, ...) whose layer dim is whole: a
    DTensor over a view of the local tensor (no communication), so an
    in-place write to it (a serving cache) reaches the stacked tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard(0) for p in t.placements):
        raise ValueError(f"layer_view: the layer dim is sharded ({t.placements})")
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in t.placements)
    shape = t.shape[1:]
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor (DTensor ops take no plain operand
    beyond a scalar), else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def maybe_shard(x: torch.Tensor, spec: Optional[Sequence]) -> torch.Tensor:
    """Lay ``x`` out by ``spec`` when it is a DTensor and a mesh is ambient;
    a no-op otherwise (a plain tensor, or no ``use_mesh``).

    Axis names in ``spec`` that the ambient mesh lacks are dropped, so the
    same model code runs on one device, the single-pod mesh
    ('data','model') and the multi-pod mesh ('pod','data','model')."""
    mesh = current_mesh()
    if spec is None or mesh is None or not is_dtensor(x):
        return x
    cleaned = clean_spec(spec, x.shape, mesh_sizes(mesh))
    return relayout(x, placements(cleaned, x.device_mesh))


def relayout(x, target: Sequence) -> torch.Tensor:
    """The DTensor ``x`` redistributed to the placements ``target``."""
    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    if x.device_mesh.device_type == "cpu":
        # gloo has no all_to_all, and DTensor's fallback for moving a shard
        # to another dim (all_gather, then chunk) leaves local tensors that
        # later ops reject (non-contiguous views; the embedding's masked
        # partial sums on a (2, 2) mesh), so go through Replicate() there,
        # both ways in the backward
        from torch.distributed.tensor import Replicate
        via = [Replicate() if a.is_shard() and b.is_shard() and a != b else a
               for a, b in zip(x.placements, target)]
        if via != list(x.placements):
            x = x.redistribute(x.device_mesh, via)
    return x.redistribute(x.device_mesh, target)


def rows_of(t) -> tuple:
    """The placements of ``t``'s batch rows alone: ``Shard(0)`` where ``t``
    shards dim 0, ``Replicate()`` on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if p.is_shard(0) else Replicate() for p in t.placements)


def key_shard(cache) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(this rank's offset in the sequence, the mesh dims that shard it) of a
    cache DTensor whose every mesh dim replicates it or shards its batch
    (dim 0) or its sequence (dim 1) evenly, as ``cache_specs`` lays caches
    out (a dim sharded over several mesh dims: major to minor); None for any
    other layout. Read from the mesh's coordinates: no communication."""
    mesh, pls = cache.device_mesh, cache.placements
    n_rows = n_keys = 1
    idx = 0
    coord = mesh.get_coordinate()
    dims = []
    for i, p in enumerate(pls):
        n = mesh.size(i)
        if p.is_shard(0):
            n_rows *= n
        elif p.is_shard(1):
            n_keys *= n
            idx = idx * n + coord[i]
            dims.append(i)
        elif not p.is_replicate():
            return None
    if cache.shape[0] % n_rows or cache.shape[1] % n_keys:
        return None
    return idx * (cache.shape[1] // n_keys), tuple(dims)


def moved(pl: Sequence, moves: Dict[int, Optional[int]]) -> tuple:
    """``pl`` with each ``Shard(a)`` for ``a`` in ``moves`` turned into
    ``Shard(moves[a])`` (``Replicate()`` where that is None)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in pl:
        if p.is_shard() and p.dim in moves:
            p = Replicate() if moves[p.dim] is None else Shard(moves[p.dim])
        out.append(p)
    return tuple(out)


def summed_where(pl: Sequence, ref: Sequence, dims: Sequence[int]) -> tuple:
    """``pl`` with a pending sum (``Partial()``) on each mesh dim where the
    placement ``ref`` shards a tensor dim in ``dims``: the layout of the
    gradient of an operand that every rank of such a mesh dim uses whole
    with its own shard of ``ref``'s tensor."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if r.is_shard() and r.dim in dims else p for p, r in zip(pl, ref))


def on_shards(fn, args: Sequence, ins: Sequence, outs, grads: Optional[Sequence] = None):
    """``fn`` of local tensors applied to ``args``, some of them DTensors
    (``local_map``): each DTensor argument is laid out by its entry of
    ``ins`` (placements; None for a plain argument) first, its gradient comes
    back laid out by its entry of ``grads`` (``ins``'s where None), and
    ``fn``'s outputs become DTensors laid out by ``outs`` (one placements
    tuple, or a tuple of them for a tuple of outputs)."""
    from torch.distributed.tensor import DTensor, Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    grads = grads or [None] * len(args)
    laid, in_pl, grad_pl = [], [], []
    for a, pl, gpl in zip(args, ins, grads):
        if isinstance(a, DTensor):
            a = relayout(a, pl)
            in_pl.append(tuple(pl))
            grad_pl.append(tuple(gpl) if gpl is not None else tuple(pl))
        else:
            in_pl.append(None)
            grad_pl.append(None)
        laid.append(a)
    if all(isinstance(o, Placement) for o in outs):
        outs = list(outs)                 # one output (local_map reads a tuple as several)
    else:
        outs = tuple(list(o) for o in outs)
    return local_map(fn, out_placements=outs, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*laid)


# canonical logical specs used across the model zoo ----------------------------
BATCH = ("pod", "data")     # batch dim shards over pod+data


def batch_spec(*rest) -> P:
    return P(BATCH, *rest)
