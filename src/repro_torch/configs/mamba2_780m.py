"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

d_inner = 2·d_model = 3072, headdim 64 ⇒ 48 SSD heads, 1 group.
Vocab padded 50280 → 50432 for 16-way sharding (loss-masked).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm=True, ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="mamba2-reduced", family="ssm", n_layers=4, d_model=128,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=512,
    ssm=True, ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1,
    ssm_chunk=32, tie_embeddings=True, dtype="float32",
)
