"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B family (GQA, QKV bias).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936; tied embeds.
``FULL`` and ``SMOKE`` hold the values of ``repro.configs.qwen25_3b``.
"""
from repro_torch.configs.base import ModelConfig, replace

ARCH_ID = "qwen2.5-3b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256,
)
