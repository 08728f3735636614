"""deepseek-moe-16b [moe] — arXiv:2401.06066.

28L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 vocab=102400; MoE: 2
shared + 64 routed experts of width 1408, top-6 (fine-grained); the first
layer dense with d_ff 10944.  16.38 B parameters, 2.83 B active a token,
32.8 GB in bf16: it fits one 80 GB card at full depth.  ``FULL`` and
``SMOKE`` hold the values of ``repro.configs.deepseek_moe``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, replace

ARCH_ID = "deepseek-moe-16b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64, top_k=6, num_shared_experts=2, d_expert=1408,
        first_k_dense=1, dense_d_ff=10944,
    ),
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=48,
    vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=3, num_shared_experts=1, d_expert=48,
                  first_k_dense=1, dense_d_ff=128),
)
