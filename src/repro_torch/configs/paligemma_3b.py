"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma-2b backbone. [arXiv:2407.07726; hf]

SigLIP frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings; image prefix attends bidirectionally (prefix-LM).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=257216,
    gated_mlp=True, act="gelu", tie_embeddings=True,
    vision_stub=True, n_patches=256, prefix_len=256,
)

REDUCED = ArchConfig(
    name="paligemma-reduced", family="vlm", n_layers=3, d_model=128,
    n_heads=4, n_kv_heads=1, head_dim=32, d_ff=384, vocab_size=512,
    gated_mlp=True, act="gelu", tie_embeddings=True,
    vision_stub=True, n_patches=16, prefix_len=16, dtype="float32",
)
