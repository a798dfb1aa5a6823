"""Async, atomic checkpointing of nested-dict state (PyTorch counterpart of
``repro.checkpoint.checkpointer``), in the JAX package's on-disk layout:

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
the other's checkpoints. The port writes one shard a leaf; ``restore``
reassembles a leaf from any number of shards (a JAX checkpoint of a sharded
array), fills the target tree by leaf id and does not parse the JAX
``treedef`` string that the manifest also keeps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as its raw bits (uint16)."""
    t = t.detach().to("cpu", copy=True)     # never a view of state updated in place
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


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
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        """Snapshot the leaves to host memory (a copy off the card), then
        write them in the background (or at once when ``wait`` or not async)."""
        snap: List[Tuple[str, np.ndarray, str]] = [
            (lid, _to_numpy(leaf), _NP_DTYPES[leaf.dtype]) for lid, leaf in _leaves(tree)]
        treedef = f"PyTreeDef({_treedef(tree)})"
        self.wait()
        if self.async_save and not wait:
            self._thread = threading.Thread(target=self._write, args=(step, snap, treedef),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, snap, treedef)

    def _write(self, step: int, snap, treedef: str) -> None:
        final = os.path.join(self.dir, f"step_{step:06d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "treedef": treedef, "leaves": {}}
        for lid, data, dtype in snap:
            manifest["leaves"][lid] = {"shape": list(data.shape), "dtype": dtype,
                                       "shards": [[[None, None, None]] * data.ndim]}
            np.save(os.path.join(tmp, f"{lid}.0.npy"), data)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def restore(self, step: int, target: Any) -> Any:
        """A tree laid out like ``target`` with the saved values: each leaf in
        its target leaf's dtype (the saved values cast, bit for bit where the
        types agree) on the target leaf's device (the CPU for a ``meta``
        target, which gives shape and type only)."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:06d}")
        if not os.path.exists(os.path.join(d, "COMMIT")):
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def load_leaf(lid: str, leaf: torch.Tensor) -> torch.Tensor:
            meta = manifest["leaves"][lid]
            shape = tuple(meta["shape"])
            if shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {lid}: shape {shape}, target "
                                 f"{tuple(leaf.shape)}")
            bf16 = meta["dtype"] == "bfloat16"
            full = np.zeros(shape, dtype=np.uint16 if bf16 else np.dtype(meta["dtype"]))
            for i, idx in enumerate(meta["shards"]):
                index = tuple(slice(*s) if isinstance(s, list) else s for s in idx)
                full[index] = np.load(os.path.join(d, f"{lid}.{i}.npy"))
            t = torch.from_numpy(full.view(np.int16) if bf16 else full)
            if bf16:
                t = t.view(torch.bfloat16)
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            return t.to(device=dev, dtype=leaf.dtype)

        def walk(tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
            if isinstance(tree, dict):
                return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
            return load_leaf(".".join(prefix), tree)

        return walk(target)
