"""Model registry: ArchConfig → model object. The planning-graph extractor
waits until the port reaches the planner (ROADMAP)."""
from __future__ import annotations

from .config import ArchConfig
from .transformer import LM

Model = LM


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device``; non-dense families raise
    ``NotImplementedError`` naming their ROADMAP item."""
    return LM(cfg, device=device)
