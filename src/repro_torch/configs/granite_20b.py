"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 → MQA)
d_ff=24576 vocab=49152 — code model. [arXiv:2405.04324; hf]

d_ff = 4·d_model ⇒ standard (non-gated) 2-matrix MLP, matching the
20B analytic parameter count.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab_size=49152,
    gated_mlp=False, act="gelu",
)

REDUCED = ArchConfig(
    name="granite-20b-reduced", family="dense", n_layers=4, d_model=128,
    n_heads=8, n_kv_heads=1, head_dim=16, d_ff=512, vocab_size=512,
    gated_mlp=False, act="gelu", dtype="float32",
)
