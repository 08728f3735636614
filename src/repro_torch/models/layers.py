"""Transformer building blocks of the port.

The counterparts of ``repro.models.layers``: RMSNorm (every call goes
through :func:`repro_torch.kernels.ops.rmsnorm`), RoPE, the GQA attention
projections with qk-norm, paged decode/verify attention (through
:func:`repro_torch.kernels.ops.paged_attention`), chunked-prefill
attention over the gathered pages (plain PyTorch, as in JAX), the
exact-length one-shot prefill of a whole prompt into its pages, causal
attention for the full forward (dense below S = 4096, flash attention
through :func:`repro_torch.kernels.ops.flash_attention` from there, as
``repro.models.layers.causal_attention`` dispatches), and the SwiGLU MLP.

Layouts follow the JAX package at every public function: activations
``(B, S, d)``, heads ``(B, S, H, D)``, KV pools ``(P+1, bs, Hkv, D)``
whose last page is the null page.  Weights live in ``nn.Linear`` modules,
stored ``(d_out, d_in)`` (JAX keeps ``(d_in, d_out)``; the bridge
transposes).

Unlike the JAX package, which returns a new pool from every step (the
update is functional and the old pool donated), the paged functions here
write the new K/V into the pools **in place** with indexed assignment.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Cache = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; the port runs "
                         f"{sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------------
# init helpers (seeded through an explicit torch.Generator)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``nn.Linear`` weight ``(d_out, d_in)`` drawn N(0, 1/d_in) in f32 on
    the generator's device, then cast."""
    w = torch.randn((d_out, d_in), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Embedding table ``(vocab, d)`` drawn N(0, 0.02^2): keeps tied-head
    logits O(1) at initialization."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm / RoPE
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (``repro.models.layers.rmsnorm``): f32
    statistics, output in the input's dtype; runs the Triton kernel on the
    card."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalize ``x`` (..., d)."""
        return ops.rmsnorm(x, self.scale, self.eps)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """Rotary inverse frequencies ``(head_dim // 2,)`` in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(B, S, 1, D/2)`` for int positions ``(B, S)``;
    computed once per call and shared by every layer."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, D) in f32 (halves layout), cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA attention weights: q/k/v/o projections, optional qkv bias and
    qk-norm (``repro.models.layers.init_attention``)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = nn.Linear(d, cfg.q_dim, bias=cfg.qkv_bias, dtype=dtype)
        self.wk = nn.Linear(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype)
        self.wv = nn.Linear(d, cfg.kv_dim, bias=cfg.qkv_bias, dtype=dtype)
        self.wo = nn.Linear(cfg.q_dim, d, bias=False, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, dtype)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, dtype)

    def project_qkv(self, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor):
        """``_project_qkv``: x (B, S, d) -> q (B, S, H, D), k/v (B, S,
        Hkv, D), with qk-norm and RoPE applied to q and k."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        q = self.wq(x).reshape(B, S, cfg.num_heads, hd)
        k = self.wk(x).reshape(B, S, cfg.num_kv_heads, hd)
        v = self.wv(x).reshape(B, S, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Grouped-query attention without a cache (q: (B, S, H, D), k/v:
    (B, S, Hkv, D)); f32 scores, materializes (S, S)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, S, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(),
                          k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, impl: str = "auto",
                     k_chunk: int = 1024) -> torch.Tensor:
    """Dense attention for ``impl="dense"`` or (``"auto"``) S < 4096, flash
    attention otherwise (``repro.models.layers.causal_attention``)."""
    if impl not in ("auto", "dense", "chunked"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    if impl == "dense" or (impl == "auto" and q.shape[1] < 4096):
        return dense_attention(q, k, v, causal)
    return ops.flash_attention(q, k, v, causal, k_chunk)


def attention_block(attn: Attention, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (no cache): the forward pass, through
    the config's ``attn_impl`` dispatch."""
    B, S, _ = x.shape
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    out = causal_attention(q, k, v, impl=cfg.attn_impl,
                           k_chunk=cfg.attn_chunk)
    return attn.wo(out.reshape(B, S, cfg.q_dim))


class PagedWrite(NamedTuple):
    """Where one paged call writes its new K/V and what it reads: per-token
    pool coordinates ``(page, off)`` (flattened, long), the block tables
    ``(B, W)`` int32, and either the kernel's ``lengths`` (B,) int32
    (decode) or the chunk's causal ``mask`` (C, W*bs) (chunked prefill).
    Computed once per model call and shared by every layer."""

    page: torch.Tensor
    off: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor = None
    mask: torch.Tensor = None


def decode_write(index: torch.Tensor, tables: torch.Tensor, block_size: int,
                 null_page: int, K: int, valid=None) -> PagedWrite:
    """Targets of a K-token decode/verify step (``attention_decode_paged``).

    index: (B,) write position of each row's first token, -1 for an idle
    row; valid: optional (B,) real-token counts.  Token t of row b lands
    at ``index[b] + t``; idle rows and tokens ``t >= valid[b]`` go to the
    null page.  Query 0 of row b sees ``max(index[b], 0) + 1`` tokens.
    """
    W = tables.shape[1]
    ar = torch.arange(K, device=index.device)
    active = (index >= 0)[:, None]
    if valid is not None:
        active = active & (ar[None, :] < valid[:, None])
    widx = index.clamp(min=0)
    wpos = widx[:, None] + ar[None, :]                       # (B, K)
    page = tables.long().gather(1, (wpos // block_size).clamp(max=W - 1))
    page = torch.where(active, page, torch.full_like(page, null_page))
    return PagedWrite(page.reshape(-1), (wpos % block_size).reshape(-1),
                      tables, lengths=(widx + 1).to(torch.int32))


def chunk_write(hist_len: int, prompt_len: int, C: int, tables: torch.Tensor,
                block_size: int, null_page: int) -> PagedWrite:
    """Targets of one chunked-prefill slice (``attention_chunk_paged``):
    prompt positions ``[hist_len, hist_len + C)``, padding past
    ``prompt_len`` routed to the null page, and the absolute causal mask
    over the gathered pages."""
    W = tables.shape[1]
    dev = tables.device
    abs_pos = hist_len + torch.arange(C, device=dev)
    page = tables[0].long()[(abs_pos // block_size).clamp(max=W - 1)]
    page = torch.where(abs_pos < prompt_len, page,
                       torch.full_like(page, null_page))
    kv_pos = torch.arange(W * block_size, device=dev)
    return PagedWrite(page, abs_pos % block_size, tables,
                      mask=kv_pos[None, :] <= abs_pos[:, None])


def init_paged_attention_cache(cfg: ModelConfig, num_pages: int,
                               block_size: int, device: torch.device,
                               dtype: torch.dtype = None) -> Cache:
    """One layer's paged KV pool: ``(num_pages + 1, block_size, Hkv, D)``.

    The extra page (index ``num_pages``) is the null page: idle rows and
    padded prefill positions write there, so a row that owns no pages can
    never corrupt another request's cache.
    """
    dt = dtype or torch_dtype(cfg)
    shape = (num_pages + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _write_pages(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 w: PagedWrite) -> None:
    """Scatter rows of (Hkv, D) into the pools in place."""
    Hkv, D = k_new.shape[-2:]
    cache["k"][w.page, w.off] = k_new.reshape(-1, Hkv, D).to(
        cache["k"].dtype)
    cache["v"][w.page, w.off] = v_new.reshape(-1, Hkv, D).to(
        cache["v"].dtype)


def attention_decode_paged(attn: Attention, x: torch.Tensor, cache: Cache,
                           cos: torch.Tensor, sin: torch.Tensor,
                           w: PagedWrite) -> torch.Tensor:
    """K-token decode/verify against the paged pool.

    x: (B, K, d).  The new K/V are written into the pool first (so query
    t sees its own token), then the paged-attention kernel reads each
    row's reach.  Returns the attention output (B, K, d).
    """
    B, K, _ = x.shape
    q, k_new, v_new = attn.project_qkv(x, cos, sin)
    _write_pages(cache, k_new, v_new, w)
    out = ops.paged_attention(q, cache["k"], cache["v"], w.tables, w.lengths)
    return attn.wo(out.reshape(B, K, attn.cfg.q_dim))


def attention_prefill_paged(attn: Attention, x: torch.Tensor, cache: Cache,
                            cos: torch.Tensor, sin: torch.Tensor,
                            w: PagedWrite) -> torch.Tensor:
    """A whole prompt of one request at ``hist_len = 0``, exact length.

    x: (1, P, d).  The prompt's K/V are scattered into the request's pages
    (``w`` from :func:`chunk_write` with ``C = prompt_len = P``), and the
    prompt attends causally over itself through the config's
    ``attn_impl`` dispatch, as ``repro.models.layers.attention_prefill``
    does before the JAX package scatters its cache into the pool.  Returns
    the attention output (1, P, d).
    """
    _, P, _ = x.shape
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    _write_pages(cache, k, v, w)
    out = causal_attention(q, k, v, impl=cfg.attn_impl,
                           k_chunk=cfg.attn_chunk)
    return attn.wo(out.reshape(1, P, cfg.q_dim))


def attention_chunk_paged(attn: Attention, x: torch.Tensor, cache: Cache,
                          cos: torch.Tensor, sin: torch.Tensor,
                          w: PagedWrite) -> torch.Tensor:
    """One chunked-prefill slice of a single request over the paged pool.

    x: (1, C, d).  The chunk's K/V are scattered into the pool, then the
    chunk queries attend over the gathered pages of the request's table
    (history, prefix-shared pages and the chunk itself) under one
    absolute causal mask — plain PyTorch, as the JAX package does it.
    """
    _, C, _ = x.shape
    cfg = attn.cfg
    q, k_new, v_new = attn.project_qkv(x, cos, sin)
    _write_pages(cache, k_new, v_new, w)
    Hkv, D = cfg.num_kv_heads, cfg.resolved_head_dim
    pages = w.tables[0].long()
    kg = cache["k"][pages].reshape(-1, Hkv, D).float()
    vg = cache["v"][pages].reshape(-1, Hkv, D).float()
    qg = q[0].reshape(C, Hkv, cfg.num_heads // Hkv, D).float()
    s = torch.einsum("qhgd,khd->hgqk", qg, kg) / math.sqrt(D)
    s = s.masked_fill(~w.mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hgqk,khd->qhgd", p, vg).to(x.dtype)
    return attn.wo(out.reshape(1, C, cfg.q_dim))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU feed-forward weights (``repro.models.layers.init_mlp``)."""

    def __init__(self, d: int, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.wi = nn.Linear(d, d_ff, bias=False, dtype=dtype)
        self.wg = nn.Linear(d, d_ff, bias=False, dtype=dtype)
        self.wo = nn.Linear(d_ff, d, bias=False, dtype=dtype)


def mlp_block(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``silu(x Wg) * (x Wi)`` then ``Wo``."""
    return mlp.wo(F.silu(mlp.wg(x)) * mlp.wi(x))
