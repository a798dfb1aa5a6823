"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab_size=151936,
    gated_mlp=True, act="silu", qk_norm=True, rope_theta=1_000_000.0,
)

REDUCED = ArchConfig(
    name="qwen3-32b-reduced", family="dense", n_layers=4, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=512, vocab_size=512,
    gated_mlp=True, act="silu", qk_norm=True, dtype="float32",
)
