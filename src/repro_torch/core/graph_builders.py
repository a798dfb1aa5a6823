# A copy of src/repro/core/graph_builders.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Planning-graph builders: model architecture → ``ModelGraph``.

Generic transformer-family builder parameterized by the same
``ArchConfig`` the JAX model zoo consumes, plus builders for the paper's
own evaluation models (BERT-0.1B, Qwen3-0.6B/1.7B, Qwen-Omni-6B). The
multimodal builders produce *non-chain* DAGs (modality encoders feeding
a shared backbone), which is precisely what motivates the paper's
graph-based formulation (§4.1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .planning_graph import LayerNode, ModelGraph

BYTES = 2.0   # bf16


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Minimal architecture description for planning purposes."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    gated_mlp: bool = True
    seq_len: int = 512
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    attn_free: bool = False
    # enc-dec / multimodal branches: list of (branch_name, n_layers, d_model_branch, merge_proj)
    branches: Tuple[Tuple[str, int, int], ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))


def _attn_flops(s: GraphSpec, seq: int) -> float:
    """Per-sample forward FLOPs of one attention block."""
    d, hd = s.d_model, s.hd
    q = 2 * seq * d * s.n_heads * hd
    kv = 2 * 2 * seq * d * s.n_kv_heads * hd
    o = 2 * seq * s.n_heads * hd * d
    core = 2 * 2 * seq * seq * s.n_heads * hd      # QK^T + PV
    return q + kv + o + core


def _attn_params(s: GraphSpec) -> float:
    d, hd = s.d_model, s.hd
    return BYTES * (d * s.n_heads * hd * 2 + d * s.n_kv_heads * hd * 2)


def _mlp_flops(s: GraphSpec, seq: int) -> float:
    mats = 3 if s.gated_mlp else 2
    return 2.0 * seq * mats * s.d_model * s.d_ff


def _mlp_params(s: GraphSpec, d_ff: Optional[int] = None) -> float:
    mats = 3 if s.gated_mlp else 2
    return BYTES * mats * s.d_model * (d_ff or s.d_ff)


def _ssm_flops(s: GraphSpec, seq: int) -> float:
    """Mamba2-style SSD block: projections + state update."""
    d_in = 2 * s.d_model
    proj = 2 * seq * s.d_model * (2 * d_in + 2 * s.ssm_state) + 2 * seq * d_in * s.d_model
    scan = 6 * seq * d_in * s.ssm_state
    return proj + scan


def _ssm_params(s: GraphSpec) -> float:
    d_in = 2 * s.d_model
    return BYTES * (s.d_model * (2 * d_in + 2 * s.ssm_state) + d_in * s.d_model)


def build_lm_graph(spec: GraphSpec, seq_len: Optional[int] = None) -> ModelGraph:
    """Decoder-only LM (or SSM / MoE / hybrid) planning graph as a chain:
    embed → L × block → head, one node per block pre-Δ-merge."""
    seq = seq_len or spec.seq_len
    act = BYTES * seq * spec.d_model
    nodes: List[LayerNode] = [LayerNode(
        name="embed", flops_fwd=0.0, param_bytes=BYTES * spec.vocab * spec.d_model,
        act_bytes=act)]
    for i in range(spec.n_layers):
        if spec.attn_free and spec.ssm_state:
            fl = _ssm_flops(spec, seq)
            pb = _ssm_params(spec)
            state = BYTES * 2 * spec.d_model * spec.ssm_state
        else:
            fl = _attn_flops(spec, seq)
            pb = _attn_params(spec)
            state = BYTES * 2 * seq * spec.n_kv_heads * spec.hd
            if spec.n_experts:
                # active compute: top-k experts per token; params: all experts
                fl += _mlp_flops(spec, seq) * spec.experts_per_token
                fl += 2.0 * seq * spec.d_model * spec.n_experts      # router
                pb += _mlp_params(spec) * spec.n_experts
            else:
                fl += _mlp_flops(spec, seq)
                pb += _mlp_params(spec)
        nodes.append(LayerNode(name=f"block{i}", flops_fwd=fl, param_bytes=pb,
                               act_bytes=act, state_bytes=state))
    nodes.append(LayerNode(
        name="head", flops_fwd=2.0 * seq * spec.d_model * spec.vocab,
        param_bytes=BYTES * spec.vocab * spec.d_model,
        act_bytes=BYTES * seq * spec.vocab))
    return ModelGraph.chain(nodes)


def build_multimodal_graph(spec: GraphSpec, seq_len: Optional[int] = None) -> ModelGraph:
    """Branches (modality encoders) merging into the LM backbone — a
    non-chain DAG (paper Fig. 5 / §4.1 second observation)."""
    backbone = build_lm_graph(spec, seq_len)
    nodes = list(backbone.nodes)
    edges = list(backbone.edges)
    merge_target = 1  # first backbone block consumes encoder outputs
    for bname, blayers, bdim in spec.branches:
        enc_spec = GraphSpec(name=bname, n_layers=blayers, d_model=bdim,
                             n_heads=max(bdim // 64, 1), n_kv_heads=max(bdim // 64, 1),
                             d_ff=4 * bdim, vocab=0, gated_mlp=False,
                             seq_len=spec.seq_len)
        seq_b = enc_spec.seq_len
        prev = None
        for i in range(blayers):
            idx = len(nodes)
            fl = _attn_flops(enc_spec, seq_b) + _mlp_flops(enc_spec, seq_b)
            nodes.append(LayerNode(name=f"{bname}{i}", flops_fwd=fl,
                                   param_bytes=_attn_params(enc_spec) + _mlp_params(enc_spec),
                                   act_bytes=BYTES * seq_b * bdim))
            if prev is not None:
                edges.append((prev, idx))
            prev = idx
        # projector into the backbone
        idx = len(nodes)
        nodes.append(LayerNode(name=f"{bname}_proj",
                               flops_fwd=2.0 * seq_b * bdim * spec.d_model,
                               param_bytes=BYTES * bdim * spec.d_model,
                               act_bytes=BYTES * seq_b * spec.d_model))
        edges.append((prev, idx))
        edges.append((idx, merge_target))
    return ModelGraph(nodes, edges)


# -- the paper's evaluation models (Table 1) -----------------------------------
def paper_model(name: str, seq_len: int = 512) -> ModelGraph:
    if name == "bert":
        return build_lm_graph(GraphSpec("bert", 12, 768, 12, 12, 3072, 30522,
                                        gated_mlp=False, seq_len=seq_len))
    if name == "qwen3-0.6b":
        return build_lm_graph(GraphSpec("qwen3-0.6b", 28, 1024, 16, 8, 3072,
                                        151936, head_dim=128, seq_len=seq_len))
    if name == "qwen3-1.7b":
        return build_lm_graph(GraphSpec("qwen3-1.7b", 28, 2048, 16, 8, 6144,
                                        151936, head_dim=128, seq_len=seq_len))
    if name == "qwen-omni":
        spec = GraphSpec("qwen-omni", 28, 2048, 16, 8, 6144, 151936,
                         head_dim=128, seq_len=seq_len,
                         branches=(("vision", 12, 1280), ("audio", 12, 1280)))
        return build_multimodal_graph(spec, seq_len)
    raise KeyError(name)
