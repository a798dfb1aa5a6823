"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512,
160 routed experts top-6 + 2 shared, per-expert d_ff=1536.
[arXiv:2405.04434; hf]

First layer uses a dense FFN (d_ff=12288); q_lora_rank=1536,
qk_nope=128, qk_rope=64, v_head=128 per the public config.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab_size=102400,
    gated_mlp=True, act="silu",
    n_experts=160, experts_per_token=6, n_shared_experts=2,
    moe_d_ff=1536, n_dense_layers=1,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)

REDUCED = ArchConfig(
    name="deepseek-v2-reduced", family="moe", n_layers=3, d_model=128,
    n_heads=8, n_kv_heads=8, d_ff=256, vocab_size=512,
    gated_mlp=True, act="silu",
    n_experts=8, experts_per_token=2, n_shared_experts=1,
    moe_d_ff=64, n_dense_layers=1,
    mla=True, q_lora_rank=64, kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, dtype="float32",
)
