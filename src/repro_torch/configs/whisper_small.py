"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 —
encoder-decoder; conv frontend STUB (input_specs() provides 1500
precomputed frame embeddings). [arXiv:2212.04356]

Vocab padded 51865 → 52096. 12 heads are not divisible by the 16-way
model axis ⇒ attention TP via flat-projection sharding (DESIGN.md).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=51865,
    gated_mlp=False, act="gelu",
    encdec=True, n_enc_layers=12, enc_seq=1500, tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="whisper-reduced", family="encdec", n_layers=3, d_model=96,
    n_heads=4, n_kv_heads=4, head_dim=24, d_ff=256, vocab_size=512,
    gated_mlp=False, act="gelu",
    encdec=True, n_enc_layers=3, enc_seq=32, tie_embeddings=True,
    dtype="float32",
)
