"""Model registry: ArchConfig → model object + planning-graph extractor."""
from __future__ import annotations

from ..core.graph_builders import GraphSpec, build_lm_graph, build_multimodal_graph
from ..core.planning_graph import ModelGraph
from .config import ArchConfig
from .transformer import LM

Model = LM


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model for ``cfg`` on ``device``; non-dense families raise
    ``NotImplementedError`` naming their ROADMAP item."""
    return LM(cfg, device=device)


def planning_graph(cfg: ArchConfig, seq_len: int) -> ModelGraph:
    """Dora planning graph for any zoo architecture, a copy of the JAX
    package's: graph data only, so it is built for every config, also for
    the families the port cannot execute yet."""
    spec = GraphSpec(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_ff=cfg.d_ff or cfg.moe_d_ff, vocab=cfg.padded_vocab,
        head_dim=cfg.head_dim, gated_mlp=cfg.gated_mlp, seq_len=seq_len,
        n_experts=cfg.n_experts, experts_per_token=cfg.experts_per_token,
        ssm_state=cfg.ssm_state, attn_free=cfg.ssm)
    if cfg.encdec:
        spec = GraphSpec(**{**spec.__dict__,
                            "branches": (("enc", cfg.n_enc_layers, cfg.d_model),)})
        return build_multimodal_graph(spec, seq_len)
    if cfg.vision_stub:
        spec = GraphSpec(**{**spec.__dict__,
                            "branches": (("vision", 12, 1152),)})
        return build_multimodal_graph(spec, seq_len)
    return build_lm_graph(spec, seq_len)
