"""qwen3-0.6b [dense] — hf:Qwen/Qwen3-0.6B family (qk_norm, GQA).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(qwen3 uses explicit head_dim larger than d_model/num_heads); tied embeds.
"""
from repro_torch.configs.base import ModelConfig, replace

ARCH_ID = "qwen3-0.6b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
