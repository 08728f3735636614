"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts
top-2.  ``FULL`` and ``SMOKE`` hold the values of
``repro.configs.phi35_moe``.

``CUT_16L`` is the configuration the port serves on one card: FULL is
41.87 B parameters, 83.7 GB in bf16, past one 80 GB card.  One cut, of
scale: depth 32 -> 16 layers, every width and the 16 experts unchanged
(21.07 B parameters, 42.1 GB in bf16).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, replace

ARCH_ID = "phi3.5-moe-42b-a6.6b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2),
    rope_theta=10_000.0,
)

# reduced same-family config for CPU tests: small width, few experts
SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=256, moe=MoEConfig(num_experts=4, top_k=2),
)

# the served configuration: half the depth at the published widths (above)
CUT_16L = replace(FULL, name=ARCH_ID + "-16l", num_layers=16)
