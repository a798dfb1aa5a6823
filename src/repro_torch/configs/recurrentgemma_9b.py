"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 2 recurrent : 1
attention. [arXiv:2402.19427]

Pattern (rec, rec, attn) ⇒ 12 scan units + 2 unrolled recurrent layers;
local-attention window 2048; lru_width = d_model.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    gated_mlp=True, act="gelu", window=2048,
    block_pattern=("rec", "rec", "local_attn"), lru_width=4096,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="recurrentgemma-reduced", family="hybrid", n_layers=5, d_model=128,
    n_heads=4, n_kv_heads=1, head_dim=32, d_ff=384, vocab_size=512,
    gated_mlp=True, act="gelu", window=32,
    block_pattern=("rec", "rec", "local_attn"), lru_width=128,
    tie_embeddings=True, dtype="float32",
)
