"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch).

32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416, QKV bias.
``FULL`` and ``SMOKE`` hold the values of ``repro.configs.codeqwen15``.
"""
from repro_torch.configs.base import ModelConfig, replace

ARCH_ID = "codeqwen1.5-7b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256,
)
