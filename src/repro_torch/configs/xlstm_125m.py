"""xlstm-125m [ssm] — arXiv:2405.04517 (sLSTM + mLSTM blocks).

12L d_model=768 4H vocab=50304, d_ff=0 (xLSTM blocks carry their own
projections).  Pattern ``mmms``: three mLSTM blocks to one sLSTM
(xLSTM[3:1]).  Recurrent state is O(1) per token.  The same values as
``repro.configs.xlstm_125m``.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, replace

ARCH_ID = "xlstm-125m"

FULL = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(pattern="mmms", chunk_size=256),
    tie_embeddings=True,
)

SMOKE = replace(
    FULL, name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, vocab_size=256,
    xlstm=XLSTMConfig(pattern="ms", chunk_size=16),
)
