"""granite-8b [dense] — arXiv:2405.04324 (Granite Code, llama arch).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152, rope theta 1e7.
``FULL`` and ``SMOKE`` hold the values of ``repro.configs.granite_8b``.
"""
from repro_torch.configs.base import ModelConfig, replace

ARCH_ID = "granite-8b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256,
)
