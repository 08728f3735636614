"""The model config of the port: the fields the LM families read.

A copy of the LM part of ``repro.configs.base.ModelConfig`` (same field
names, defaults, derived properties and parameter accounting) with its
sub-configs ``MoEConfig``, ``MambaConfig``, ``XLSTMConfig`` and the
modality stub ``FrontendConfig`` as data, so configs compare field by
field across the two packages, and a whole copy of its
``OptimizerConfig``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration
    (:func:`repro_torch.models.layers.moe_block`)."""

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
    # einsum (GShard one-hot products) | scatter (indexed); the port
    # computes both through one index-based dispatch
    dispatch: str = "einsum"


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
class FrontendConfig:
    """Modality frontend stub of the vlm and audio archs: the backbone
    takes precomputed patch embeddings (vlm) or folded codebook token ids
    (audio); no frontend weights are built."""

    kind: str = "none"               # 'none' | 'vision' | 'audio'
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl M-RoPE
    num_codebooks: int = 4           # musicgen EnCodec streams (folded)


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-LM configuration: dense and moe (attention + SwiGLU or
    MoE), hybrid (Mamba/attention interleave), ssm (xLSTM), and the vlm
    and audio backbones behind their stub frontends."""

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
    use_mrope: bool = False          # qwen2-vl
    # 'auto'': flash attention (online softmax over KV chunks; the card's
    # flash kernels) from S = 4096 up, dense below
    attn_impl: str = "auto"          # auto | dense | chunked
    attn_chunk: int = 1024           # KV chunk of the plain flash version

    # block pattern for hybrid archs, cycled over layers: 'a' attention,
    # 'M' mamba; dense archs use all-'a'
    block_pattern: str = "a"

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)

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

    # --- parameter accounting (MODEL_FLOPS = 6 * N * tokens) --------------
    def _attn_params(self) -> int:
        p = self.d_model * (self.q_dim + 2 * self.kv_dim)      # wq wk wv
        p += self.q_dim * self.d_model                          # wo
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            p += 2 * self.resolved_head_dim
        return p

    def _dense_ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff                  # SwiGLU wi, wg, wo

    def _moe_ffn_params(self, active_only: bool) -> int:
        m = self.moe
        per_expert = 3 * self.d_model * (m.d_expert or self.d_ff)
        router = self.d_model * m.num_experts
        shared = m.num_shared_experts * per_expert
        routed = (m.top_k if active_only else m.num_experts) * per_expert
        return router + shared + routed

    def _mamba_params(self) -> int:
        mc = self.mamba or MambaConfig()
        d_in = mc.expand * self.d_model
        dt_rank = mc.dt_rank or math.ceil(self.d_model / 16)
        p = self.d_model * 2 * d_in                 # in_proj (x and z)
        p += d_in * mc.d_conv                       # depthwise conv
        p += d_in * (dt_rank + 2 * mc.d_state)      # x -> (dt, B, C)
        p += dt_rank * d_in + d_in                  # dt proj + bias
        p += d_in * mc.d_state + d_in               # A_log, D
        p += d_in * self.d_model                    # out_proj
        return p

    def _xlstm_params(self) -> int:
        xc = self.xlstm or XLSTMConfig()
        d = self.d_model
        dm = int(xc.proj_factor_mlstm * d)
        m = 2 * d * dm + 3 * dm * dm // 4 + 3 * dm + dm * d
        s = 4 * (d * d + d * d // 4) + int(xc.proj_factor_slstm * d) * d * 2
        n_m = sum(1 for i in range(self.num_layers)
                  if xc.pattern[i % len(xc.pattern)] == "m")
        return n_m * m + (self.num_layers - n_m) * s

    def param_count(self, active_only: bool = False) -> int:
        """Total parameters, or with ``active_only`` those one token runs
        through (top-k of the routed experts), by the JAX package's
        formula (``repro.configs.base.ModelConfig.param_count``; an
        estimate for the xLSTM and Mamba mixers)."""
        n = self.vocab_size * self.d_model                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model                 # lm head
        n += self.d_model                                       # final norm
        if self.family == "ssm" and self.xlstm is not None:
            return n + self._xlstm_params()
        for i, kind in enumerate(self.layer_kinds()):
            n += 2 * self.d_model                               # 2 norms
            if kind == "a":
                n += self._attn_params()
            elif kind == "M":
                n += self._mamba_params()
            if kind == "a" or self.family == "hybrid":
                if self.is_moe_layer(i):
                    n += self._moe_ffn_params(active_only)
                else:
                    d_ff = self.d_ff
                    if self.moe is not None and i < self.moe.first_k_dense:
                        d_ff = self.moe.dense_d_ff or self.d_ff
                    if d_ff:
                        n += self._dense_ffn_params(d_ff)
        return n


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
