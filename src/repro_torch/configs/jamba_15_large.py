"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (Mamba+attn 1:7, MoE).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Block pattern: 1 attention : 7 mamba per 8-layer period; MoE every 2nd
layer.  ``FULL`` and ``SMOKE`` hold the values of
``repro.configs.jamba_15_large``; both build with their MoE FFNs (a
FULL model, 398 B parameters, fits no one card).

``NOEXP_8L`` is the configuration the port serves and trains on one
card: one whole period ``MMMMaMMM`` at the published widths (d_model
8192, 64 heads over 8 KV heads, head_dim 128, d_ff 24576, vocab 65536,
Mamba d_state 16, d_conv 4, expand 2 so d_in 16384, dt_rank 512), about
9.0 B parameters, 18 GB in bf16.  Two cuts, both of scale:

* depth 72 -> 8 (one period of the repeating pattern);
* no experts: every layer keeps the dense SwiGLU FFN of width d_ff
  (``moe=None``); with MoE one expert layer alone is 19 GB in bf16 and the
  whole model 398 B parameters, past one 80 GB card.
"""
from repro_torch.configs.base import (MambaConfig, ModelConfig, MoEConfig,
                                     replace)

ARCH_ID = "jamba-1.5-large-398b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern="MMMMaMMM",       # attn at position 4 of each 8-layer period
    moe=MoEConfig(num_experts=16, top_k=2, moe_period=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=256, block_pattern="MMaM",
    moe=MoEConfig(num_experts=4, top_k=2, moe_period=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
)

# the served configuration: cut to one period and to no experts (above)
NOEXP_8L = replace(FULL, name="jamba-1.5-large-398b-noexp-8l", num_layers=8,
                   moe=None)
