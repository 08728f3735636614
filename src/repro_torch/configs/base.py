"""The model config of the port: the fields the LM families read.

A copy of the LM part of ``repro.configs.base.ModelConfig`` (same field
names, defaults and derived properties; no modality frontend) with its
sub-configs ``MoEConfig``, ``MambaConfig`` and ``XLSTMConfig`` as data, so
configs compare field by field across the two packages, and a whole copy
of its ``OptimizerConfig``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (data only: the port has no
    MoE FFN yet, and a layer that needs one raises)."""

    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0      # deepseek-style always-on shared experts
    d_expert: int = 0                # per-expert hidden dim (0 -> use d_ff)
    capacity_factor: float = 1.25    # tokens per expert = cf * tokens * k / E
    first_k_dense: int = 0           # deepseek: first k layers use dense FFN
    dense_d_ff: int = 0              # d_ff of those dense layers
    moe_period: int = 1              # MoE every `period` layers (jamba: 2)
    router_aux_weight: float = 0.01  # load-balancing aux loss weight
    router_z_weight: float = 1e-4    # router z-loss weight
    dispatch: str = "einsum"         # einsum | scatter


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack configuration (mLSTM/sLSTM interleave)."""

    # pattern string over layers, cycled: 'm' = mLSTM, 's' = sLSTM
    pattern: str = "msmmmms"
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    conv_kernel: int = 4
    chunk_size: int = 64             # chunkwise-parallel mLSTM chunk


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-LM configuration: dense (attention + SwiGLU), hybrid
    (Mamba/attention interleave) and ssm (xLSTM) families."""

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

    # block pattern for hybrid archs, cycled over layers: 'a' attention,
    # 'M' mamba; dense archs use all-'a'
    block_pattern: str = "a"

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

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

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, cycling ``block_pattern``."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def is_moe_layer(self, i: int) -> bool:
        """Does layer ``i`` take a MoE FFN?"""
        if self.moe is None:
            return False
        if i < self.moe.first_k_dense:
            return False
        return (i % self.moe.moe_period) == (self.moe.moe_period - 1) \
            if self.moe.moe_period > 1 else True


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


def replace(cfg, **kw):
    """A copy of ``cfg`` with the given fields replaced; a dotted key
    (``"xlstm.chunk_size"``) replaces a field of a sub-config."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested = {k: v for k, v in kw.items() if "." in k}
    out = dataclasses.replace(cfg, **direct) if direct else cfg
    for k, v in nested.items():
        head, rest = k.split(".", 1)
        sub = getattr(out, head)
        out = dataclasses.replace(out, **{head: replace(sub, **{rest: v})})
    return out
