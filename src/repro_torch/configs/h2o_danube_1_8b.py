"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=80, d_ff=6912, vocab_size=32000,
    gated_mlp=True, act="silu", window=4096,
)

REDUCED = ArchConfig(
    name="h2o-danube-reduced", family="dense", n_layers=4, d_model=128,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=384, vocab_size=512,
    gated_mlp=True, act="silu", window=32, dtype="float32",
)
