"""The model config of the port: the fields the dense LM family reads.

A copy of the dense-family part of ``repro.configs.base.ModelConfig``
(same field names, defaults and derived properties), so configs compare
field by field across the two packages, and a whole copy of its
``OptimizerConfig``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-LM configuration (dense family: attention + SwiGLU)."""

    name: str = "model"
    family: str = "dense"

    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5/2.5
    rope_theta: float = 10_000.0
    # 'auto': flash attention (online softmax over KV chunks; the card's
    # flash kernels) from S = 4096 up, dense below
    attn_impl: str = "auto"          # auto | dense | chunked
    attn_chunk: int = 1024           # KV chunk of the plain flash version

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        """Per-head width (``head_dim``, or ``d_model // num_heads``)."""
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        """Width of the query projection."""
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        """Width of each of the key and value projections."""
        return self.num_kv_heads * self.resolved_head_dim


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer and schedule (``repro.configs.base.OptimizerConfig``)."""

    name: str = "adam"               # adam | adamw | adafactor | sgd
    lr: float = 1e-3                 # paper: Adam, initial lr 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    schedule: str = "constant"       # constant | cosine | linear
    total_steps: int = 10_000
    # moment dtype: 'float32' for fidelity, 'bfloat16' to halve optimizer HBM
    moment_dtype: str = "float32"


def replace(cfg: ModelConfig, **kw) -> ModelConfig:
    """A copy of ``cfg`` with the given fields replaced (the port's config
    has no nested sub-configs, so no dotted keys)."""
    return dataclasses.replace(cfg, **kw)
