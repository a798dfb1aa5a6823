"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) per-expert d_ff=1024
vocab=50304, 64 experts top-8. [arXiv:2409.02060; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024, vocab_size=50304,
    gated_mlp=True, act="silu", qk_norm=True,
    n_experts=64, experts_per_token=8, moe_d_ff=1024,
)

REDUCED = ArchConfig(
    name="olmoe-reduced", family="moe", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    gated_mlp=True, act="silu", qk_norm=True,
    n_experts=8, experts_per_token=2, moe_d_ff=128, dtype="float32",
)
