"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch code model. [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=49152,
    gated_mlp=True, act="silu",
)

REDUCED = ArchConfig(
    name="granite-8b-reduced", family="dense", n_layers=4, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=448, vocab_size=512,
    gated_mlp=True, act="silu", dtype="float32",
)
