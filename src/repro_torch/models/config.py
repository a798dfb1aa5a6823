"""Unified architecture config covering every assigned model family.

A copy of ``repro.models.config``; ``tests/test_torch_configs.py`` holds
the two equal field by field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    gated_mlp: bool = True
    act: str = "silu"              # silu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # -- attention variants --------------------------------------------------
    window: Optional[int] = None   # sliding-window attention (SWA)
    prefix_len: int = 0            # prefix-LM bidirectional span (VLM)

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 0            # dispatch groups (0 = auto; see mlp.py)

    # -- MLA (DeepSeek) ---------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- SSM (Mamba2 / SSD) -------------------------------------------------------
    ssm: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # -- hybrid (RecurrentGemma) -----------------------------------------------------
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rglru", "rglru", "attn")
    lru_width: Optional[int] = None
    conv_width: int = 4

    # -- encoder-decoder (Whisper) ------------------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500            # conv-frontend output frames (stub input)

    # -- VLM (PaliGemma) -------------------------------------------------------------------
    vision_stub: bool = False
    n_patches: int = 256

    # -- numerics / padding ---------------------------------------------------------------
    dtype: str = "bfloat16"
    vocab_pad: int = 256
    max_seq: int = 8192            # positional table length where applicable
    scan_unroll: bool = False      # unroll layer scans (dry-run cost probes)
    attn_chunk: int = 2048         # query-chunk attention above this seq len

    # -------------------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / self.vocab_pad) * self.vocab_pad)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def param_count(self) -> float:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0.0
        if self.ssm:
            din = self.d_inner
            per_layer = d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                             + self.ssm_nheads) + din * d \
                + self.ssm_conv * (din + 2 * self.ssm_ngroups * self.ssm_state) \
                + 2 * self.ssm_nheads
            return emb + self.n_layers * per_layer
        if self.mla:
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mats = 3 if self.gated_mlp else 2
        dense_mlp = mats * d * self.d_ff
        if self.n_experts:
            moe_mlp = mats * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts) \
                + d * self.n_experts
            n_moe = self.n_layers - self.n_dense_layers
            total = emb + self.n_layers * attn + self.n_dense_layers * dense_mlp \
                + n_moe * moe_mlp
            return total
        total_layers = self.n_layers + (self.n_enc_layers if self.encdec else 0)
        per = attn + dense_mlp
        if self.encdec:
            per = per  # decoder layers also carry cross-attention
            total = emb + self.n_layers * (attn * 2 + dense_mlp) \
                + self.n_enc_layers * (attn + dense_mlp)
            return total
        if self.block_pattern:
            # hybrid: count recurrent vs attention blocks
            n = self.n_layers
            pat = [self.block_pattern[i % len(self.block_pattern)] for i in range(n)]
            lru = self.lru_dim
            rec = d * lru * 2 + lru * d + 2 * lru * self.conv_width + 4 * lru
            total = emb
            for kind in pat:
                total += dense_mlp + (rec if kind == "rglru" else attn)
            return total
        return emb + self.n_layers * per

    def active_param_count(self) -> float:
        """Active (per-token) parameters — MoE top-k only."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        mats = 3 if self.gated_mlp else 2
        full = self.param_count()
        all_experts = mats * d * self.moe_d_ff * self.n_experts
        active = mats * d * self.moe_d_ff * self.experts_per_token
        n_moe = self.n_layers - self.n_dense_layers
        return full - n_moe * (all_experts - active)
