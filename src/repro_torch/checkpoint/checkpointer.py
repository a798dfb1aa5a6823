"""Sharded, async, atomic checkpointing of nested-dict state with elastic
restore (PyTorch counterpart of ``repro.checkpoint.checkpointer``), in the
JAX package's on-disk layout:

    <dir>/step_000123.tmp/              — written first
        MANIFEST.json                   — step, tree description, per-leaf
                                          shape, dtype and shard indices
        <leaf_id>.<shard_idx>.npy       — one file per shard
    <dir>/step_000123/                  — atomic rename on completion
        COMMIT                          — marker: checkpoint is complete

Leaf ids are the dict keys joined by ``.`` (``params.stack.u0.mixer.wq``),
as the JAX package's ``_leaf_id`` makes them. numpy has no bfloat16, so a
bf16 leaf is stored as its raw 16 bits (``uint16``) with ``"dtype":
"bfloat16"`` in the manifest, and restored bit for bit: each package reads
the other's checkpoints.

A plain tensor is one shard. A DTensor leaf is saved as its distinct
shards, each with its global index in the manifest; a shard that several
ranks hold (replicated over a mesh dim) is written once, by the lowest
of them, and rank 0 writes the manifest and ``COMMIT`` after every rank's
files are on disk. Across ranks the write runs in the background thread
and the commit (two barriers of the default process group) on the calling
thread, in ``wait()`` or the next ``save()``: a collective from the writer
thread could interleave with the training step's own. Every rank of the
group calls ``save``, ``wait`` and ``restore`` alike.

``restore`` fills the target tree by leaf id (the JAX ``treedef`` string
that the manifest keeps is not parsed). A DTensor target (its local tensor
may be on the ``meta`` device: shape, type and layout only) is rebuilt on
each rank from the saved shards that overlap its own slice, with no
collective, on any mesh: the layout it was saved from does not matter.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.sharding_utils import is_dtensor

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
              torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
              torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
              torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    """(leaf id, leaf) in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield ".".join(prefix), tree


def _treedef(tree: Any) -> str:
    """The tree's structure in the form of JAX's ``str(treedef)`` (sorted keys)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


Box = Tuple[Tuple[int, int], ...]       # (start, size) a tensor dim


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as its raw bits (uint16)."""
    t = t.detach().to("cpu", copy=True)     # never a view of state updated in place
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _group() -> Tuple[int, int]:
    """(rank, world) of the default process group; (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def shard_boxes(shape: Sequence[int], mesh_shape: Sequence[int], placements) -> List[Box]:
    """The slice of a ``shape`` tensor that each mesh coordinate holds under
    ``placements`` (coordinates in row-major order), as DTensor lays it out:
    ``Shard(d)`` splits the slice's dim d into ``torch.chunk`` pieces, mesh
    dims major to minor."""
    out = []
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        box = [(0, n) for n in shape]
        for md, pl in enumerate(placements):
            if pl.is_shard():
                lo, n = box[pl.dim]
                chunk = -(-n // mesh_shape[md])
                start = min(coord[md] * chunk, n)
                box[pl.dim] = (lo + start, min(chunk, n - start))
        out.append(tuple(box))
    return out


def _index_json(box: Box, shape: Sequence[int]) -> List:
    """A shard's global index as the JAX package writes it: ``[start, stop,
    None]`` a dim, ``[None, None, None]`` where the shard spans the dim."""
    return [[None, None, None] if (lo, n) == (0, full) else [lo, lo + n, None]
            for (lo, n), full in zip(box, shape)]


def _index_box(idx: List, shape: Sequence[int]) -> Box:
    out = []
    for s, full in zip(idx, shape):
        if isinstance(s, list):
            lo, hi, _ = slice(*s).indices(full)
            out.append((lo, hi - lo))
        else:
            out.append((s, 1))
    return tuple(out)


def _dtensor_shards(t, rank: int) -> Tuple[List[Box], Optional[int]]:
    """The distinct shards of DTensor ``t`` in the manifest's order (by the
    lowest rank holding each), and the position of the one ``rank`` writes
    (None when a lower rank holds the same)."""
    mesh = t.device_mesh
    boxes = shard_boxes(t.shape, tuple(mesh.shape), t.placements)
    writer: Dict[Box, int] = {}
    for box, r in zip(boxes, mesh.mesh.reshape(-1).tolist()):
        if all(n > 0 for _, n in box):
            writer[box] = min(r, writer.get(box, r))
    order = sorted(writer, key=writer.get)
    mine = [i for i, box in enumerate(order) if writer[box] == rank]
    return order, (mine[0] if mine else None)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._commit: Optional[Tuple[int, Dict[str, Any]]] = None   # across ranks, in wait()
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        """Snapshot this rank's shards to host memory (a copy off the card),
        then write them in the background (or at once when ``wait`` or not
        async)."""
        rank, world = _group()
        manifest: Dict[str, Any] = {"step": step, "treedef": f"PyTreeDef({_treedef(tree)})",
                                    "leaves": {}}
        snap: List[Tuple[str, int, np.ndarray]] = []
        for lid, leaf in _leaves(tree):
            shape = tuple(leaf.shape)
            if is_dtensor(leaf):
                order, mine = _dtensor_shards(leaf, rank)
                if mine is not None:
                    snap.append((lid, mine, _to_numpy(leaf.to_local())))
            else:                       # a plain tensor: the same on every rank
                order = [tuple((0, n) for n in shape)]
                if rank == 0:
                    snap.append((lid, 0, _to_numpy(leaf)))
            manifest["leaves"][lid] = {"shape": list(shape), "dtype": _NP_DTYPES[leaf.dtype],
                                       "shards": [_index_json(b, shape) for b in order]}
        self.wait()
        tmp = os.path.join(self.dir, f"step_{step:06d}.tmp")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if world > 1:
            _barrier()                  # the directory exists before any rank writes
        if world > 1:
            self._commit = (step, manifest)
        args = (tmp, snap, None if world > 1 else (step, manifest))
        if self.async_save and not wait:
            self._thread = threading.Thread(target=self._write, args=args, daemon=True)
            self._thread.start()
        else:
            self._write(*args)
            if wait:
                self.wait()

    def _write(self, tmp: str, snap, commit: Optional[Tuple[int, Dict[str, Any]]]) -> None:
        for lid, i, data in snap:
            np.save(os.path.join(tmp, f"{lid}.{i}.npy"), data)
        if commit is not None:
            self._finish(*commit)

    def _finish(self, step: int, manifest: Dict[str, Any]) -> None:
        final = os.path.join(self.dir, f"step_{step:06d}")
        with open(os.path.join(final + ".tmp", "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(final + ".tmp", final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
        self._gc()

    def wait(self) -> None:
        """Finish the last save: join the writer, then (across ranks) commit
        it once every rank's files are on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._commit is not None:
            commit, self._commit = self._commit, None
            _barrier()
            if _group()[0] == 0:
                self._finish(*commit)
            _barrier()                  # COMMIT is visible to every rank

    def _gc(self) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def restore(self, step: int, target: Any) -> Any:
        """A tree laid out like ``target`` with the saved values: each leaf in
        its target leaf's dtype (the saved values cast, bit for bit where the
        types agree). A plain leaf comes back whole on its target's device
        (the CPU for a ``meta`` target); a DTensor leaf as a DTensor of the
        target's mesh and placements, each rank reading only what overlaps
        its own slice (on the mesh's device for a ``meta`` local tensor)."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:06d}")
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def read(lid: str, meta: Dict[str, Any], box: Box) -> torch.Tensor:
            """The slice ``box`` of the saved leaf, from every shard overlapping it."""
            bf16 = meta["dtype"] == "bfloat16"
            shape = tuple(meta["shape"])
            out = np.zeros(tuple(n for _, n in box),
                           dtype=np.uint16 if bf16 else np.dtype(meta["dtype"]))
            for i, idx in enumerate(meta["shards"]):
                src = _index_box(idx, shape)
                lo = [max(a, b) for (a, _), (b, _) in zip(src, box)]
                hi = [min(a + m, b + n) for (a, m), (b, n) in zip(src, box)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                data = np.load(os.path.join(d, f"{lid}.{i}.npy"), mmap_mode="r")
                out[tuple(slice(l - b, h - b) for l, h, (b, _) in zip(lo, hi, box))] = \
                    data[tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, src))]
            t = torch.from_numpy(out.view(np.int16) if bf16 else out)
            return t.view(torch.bfloat16) if bf16 else t

        def load_leaf(lid: str, leaf: torch.Tensor) -> torch.Tensor:
            meta = manifest["leaves"][lid]
            shape = tuple(meta["shape"])
            if shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {lid}: shape {shape}, target "
                                 f"{tuple(leaf.shape)}")
            if not is_dtensor(leaf):
                dev = "cpu" if leaf.device.type == "meta" else leaf.device
                return read(lid, meta, tuple((0, n) for n in shape)).to(device=dev,
                                                                       dtype=leaf.dtype)
            from torch.distributed.tensor import DTensor
            mesh = leaf.device_mesh
            local = leaf.to_local()
            dev = local.device
            if dev.type == "meta":
                dev = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))
            coord = mesh.get_coordinate()
            box = shard_boxes(shape, tuple(mesh.shape), leaf.placements)[
                int(np.ravel_multi_index(coord, tuple(mesh.shape)))]
            t = read(lid, meta, box).to(device=dev, dtype=leaf.dtype)
            return DTensor.from_local(t, mesh, leaf.placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())

        def walk(tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
            if isinstance(tree, dict):
                return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
            return load_leaf(".".join(prefix), tree)

        return walk(target)
