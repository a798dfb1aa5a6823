"""Carry parameters from the JAX package to the port.

``from_numpy`` takes the tree that ``repro.models.transformer.LM(cfg).init``
returns, with every leaf turned into a numpy array (``jax.tree.map(np.asarray,
params)``), and gives the port's parameters: the same nested dicts with the
same layouts (``wq (d,H,hd)``, ``wo (H,hd,d)``, the stacked
``params["stack"]["u0"][...]`` leaves of shape ``(n_units, ...)``), as
tensors of the same dtype on ``device``. The optimizer state of
``repro.optim.adamw_init`` / ``adamw_update`` converts the same way: its
``{"m", "v", "count"}`` tree gives float32 moment trees laid out like the
parameters and a 0-d int32 ``count``, as ``repro_torch.optim`` keeps them,
so both packages can start a training step from one state. This module
imports neither JAX nor the JAX package: bfloat16 leaves arrive as numpy's
``bfloat16`` extension dtype and are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(a: Any, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts of numpy arrays (parameters or optimizer state, 0-d
    leaves included) → the same nested dicts of tensors, on the card unless
    ``device`` says otherwise (the port's default)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
