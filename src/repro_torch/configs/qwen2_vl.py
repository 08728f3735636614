"""qwen2-vl-7b [vlm] — arXiv:2409.12191 (M-RoPE, dynamic resolution).

28L d_model=3584 28H (GQA kv=4, 7 query heads a KV head) d_ff=18944
vocab=152064, QKV bias.  Backbone only: the vision frontend is a stub; a
batch carries precomputed patch embeddings (``embeds``) and 3-component
M-RoPE positions (``positions``, (3, B, S)), whose components rotate the
frequency sections ``mrope_sections`` of each head.  ``FULL`` and
``SMOKE`` hold the values of ``repro.configs.qwen2_vl``.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, replace

ARCH_ID = "qwen2-vl-7b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    use_mrope=True,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", mrope_sections=(16, 24, 24)),
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256,
    frontend=FrontendConfig(kind="vision", mrope_sections=(4, 2, 2)),
)
