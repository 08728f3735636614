"""musicgen-medium [audio] — arXiv:2306.05284 (decoder over EnCodec tokens).

48L d_model=1536 24H (kv=24 = MHA, head_dim 64) d_ff=6144 vocab=2048.
Backbone only: the EnCodec frontend is a stub, and the model reads token
ids of the folded, codebook-interleaved stream, so it trains and serves
through the dense path.  ``FULL`` and ``SMOKE`` hold the values of
``repro.configs.musicgen_medium``.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, replace

ARCH_ID = "musicgen-medium"

FULL = ModelConfig(
    name=ARCH_ID,
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend=FrontendConfig(kind="audio", num_codebooks=4),
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=64,
    frontend=FrontendConfig(kind="audio", num_codebooks=2),
)
