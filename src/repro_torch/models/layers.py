"""Transformer building blocks of the port.

The counterparts of ``repro.models.layers``: RMSNorm (every call goes
through :func:`repro_torch.kernels.ops.rmsnorm`), RoPE and qwen2-vl's
M-RoPE (as cos/sin tables, so attention keeps one rotation), the GQA attention
projections with qk-norm, paged decode/verify attention (through
:func:`repro_torch.kernels.ops.paged_attention`), chunked-prefill
attention over the gathered pages (plain PyTorch, as in JAX), the
exact-length one-shot prefill of a whole prompt into its pages, the dense
slot rows with their batch prefill and decode (plain PyTorch products
over the rows, as JAX computes them outside any Pallas kernel), causal
attention for the full forward (dense below S = 4096, flash attention
through :func:`repro_torch.kernels.ops.flash_attention` from there, as
``repro.models.layers.causal_attention`` dispatches), the SwiGLU MLP and
the capacity-based top-k mixture of experts (plain PyTorch products and
indexing, as the JAX package computes it outside any Pallas kernel).

Layouts follow the JAX package at every public function: activations
``(B, S, d)``, heads ``(B, S, H, D)``, KV pools ``(P+1, bs, Hkv, D)``
whose last page is the null page, dense rows ``(B, max_len, Hkv, D)``.
Weights live in ``nn.Linear`` modules,
stored ``(d_out, d_in)`` (JAX keeps ``(d_in, d_out)``; the bridge
transposes).

On a tensor-parallel shard (:mod:`repro_torch.parallel.tensor`) the
attention and MLP modules hold their cut of the heads and of d_ff and a
``tp`` whose all-reduce sums the row-parallel ``wo`` outputs
(:meth:`Attention.project_out`, :func:`mlp_block`); with ``tp`` None the
ops are the single-device ones.

Unlike the JAX package, which returns a new pool from every step (the
update is functional and the old pool donated), the paged and dense decode
functions here write the new K/V into the pools and rows **in place** with
indexed assignment.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

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


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qwen2-vl's multimodal RoPE as cos/sin tables ``(B, S, 1, D/2)``
    (``repro.models.layers.apply_mrope``): int positions ``(3, B, S)``
    hold the temporal, height and width components, and ``sections``
    gives the first ``sections[0]`` of the D/2 rotary frequencies to the
    first component, the next ``sections[1]`` to the second, the rest to
    the third."""
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE takes (3, B, S) positions, got "
                         f"{tuple(positions.shape)}")
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must cover "
                         f"the {head_dim // 2} rotary frequencies")
    freqs = rope_freqs(head_dim, theta, positions.device)
    sec = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(list(sections), device=positions.device))
    angles = positions.float()[sec].permute(1, 2, 0) * freqs  # (B, S, D/2)
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
        # the model axis (:class:`repro_torch.parallel.tensor.
        # TensorParallel`) when this rank holds a cut of the heads: ``wo``
        # is row-parallel and its partial sums are all-reduced
        self.tp = None

    def project_out(self, out: torch.Tensor) -> torch.Tensor:
        """``wo`` over the heads' output (..., q_dim), summed over the
        model ranks when the heads are cut across them."""
        y = self.wo(out)
        return y if self.tp is None else self.tp.all_reduce(y)

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
    return attn.project_out(out.reshape(B, S, cfg.q_dim))


class PagedWrite(NamedTuple):
    """Where one paged call writes its new K/V and what it reads: per-token
    pool coordinates ``(page, off)`` (flattened, long), the block tables
    ``(B, W)`` int32, and either the kernel's ``lengths`` (B,) int32
    (decode) or the chunk's causal ``mask`` (C, W*bs) (chunked prefill).
    ``shards`` > 1 says the pool is split into that many private sub-pools
    (the serving mesh's ``data`` axis), so the decode reads go through the
    sharded dispatch; the caller chooses it, no global context does.
    Computed once per model call and shared by every layer."""

    page: torch.Tensor
    off: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor = None
    mask: torch.Tensor = None
    shards: int = 1


def decode_write(index: torch.Tensor, tables: torch.Tensor, block_size: int,
                 null_page: int, K: int, valid=None,
                 shards: int = 1) -> PagedWrite:
    """Targets of a K-token decode/verify step (``attention_decode_paged``).

    index: (B,) write position of each row's first token, -1 for an idle
    row; valid: optional (B,) real-token counts.  Token t of row b lands
    at ``index[b] + t``; idle rows and tokens ``t >= valid[b]`` go to the
    null page.  Query 0 of row b sees ``max(index[b], 0) + 1`` tokens.
    ``shards``: the pool's data shards (:class:`PagedWrite`).  The writes
    use global page ids; an idle row's dead writes land on the pool's
    last page (the last shard's null page, as JAX's mesh writes them),
    whose contents no live row reads.
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
                      tables, lengths=(widx + 1).to(torch.int32),
                      shards=shards)


def decode_scan(step_fn: Callable, x: torch.Tensor, state: Cache,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """Drive a single-token recurrent decode step over K tokens
    (``repro.models.layers.decode_scan``).

    ``step_fn(x_t (B, 1, d), state) -> (out (B, 1, d), new state)`` is a
    recurrent mixer's decode step; x is (B, K, d).  With ``valid`` ((B,)
    ints) row b keeps its state after its first ``valid[b]`` tokens: a
    ``torch.where`` on the row mask, so the steps past it still compute
    (garbage) outputs but leave the carried state as it was -- the
    masking a speculative verify and a rollback replay rely on.  Returns
    (out (B, K, d), new state); ``state`` itself is not written.
    """
    B, K, _ = x.shape
    if K == 1 and valid is None:
        return step_fn(x, state)
    outs = []
    for t in range(K):
        out, new = step_fn(x[:, t:t + 1], state)
        if valid is not None:
            keep = t < valid
            new = {k: torch.where(keep.view((B,) + (1,) * (v.dim() - 1)),
                                  v, state[k]) for k, v in new.items()}
        state = new
        outs.append(out)
    return torch.cat(outs, dim=1), state


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


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         device: torch.device,
                         dtype: torch.dtype = None) -> Cache:
    """One layer's dense KV rows (``repro.models.layers.
    init_attention_cache``): ``k``/``v`` of ``(batch, max_len, Hkv, D)``,
    row b the whole cache of the request in slot b."""
    dt = dtype or torch_dtype(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


class DenseWrite(NamedTuple):
    """Where one dense decode/verify call writes its new K/V and what each
    query reaches, computed once per model call and shared by every
    layer: flattened ``(B*K,)`` ``rows`` and target positions ``pos``,
    ``keep`` (false for a write at or past ``max_len``, which JAX's
    ``mode="drop"`` scatter drops) and ``reach`` (B, K), the last position
    token t of row b attends to (``index[b] + t``)."""

    rows: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    reach: torch.Tensor


def dense_write(index: torch.Tensor, K: int, max_len: int) -> DenseWrite:
    """Targets of a K-token step over dense rows (``attention_decode``).

    index: (B,) write position of each row's first token.  A write at
    ``index[b] + t >= max_len`` must be dropped; indexing past the row
    would raise (a device assert on the card), and a host check of the
    mask would stall the step.  Such a write is aimed instead at
    ``index[b] - 1``, a position no token of this call writes, with that
    position's own value (:func:`_write_rows` reads it first), so every
    duplicate target receives the same bits.  (K <= max_len keeps
    ``index[b] >= 1`` for a row that drops.)
    """
    B = index.shape[0]
    if K > max_len:
        raise ValueError(f"{K} tokens a row do not fit rows of {max_len}")
    ar = torch.arange(K, device=index.device)
    reach = index[:, None] + ar[None, :]                     # (B, K)
    keep = reach < max_len
    pos = torch.where(keep, reach, (index - 1).clamp(min=0)[:, None])
    rows = torch.arange(B, device=index.device)[:, None].expand(B, K)
    return DenseWrite(rows.reshape(-1), pos.reshape(-1), keep.reshape(-1),
                      reach)


def _write_rows(cache: Cache, k_new: torch.Tensor, v_new: torch.Tensor,
                w: DenseWrite) -> None:
    """Write rows of (Hkv, D) into the dense cache in place; a dropped
    write puts back the value its target holds."""
    Hkv, D = k_new.shape[-2:]
    keep = w.keep[:, None, None]
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = cache[name]
        new = new.reshape(-1, Hkv, D).to(leaf.dtype)
        leaf[w.rows, w.pos] = torch.where(keep, new, leaf[w.rows, w.pos])


def attention_prefill(attn: Attention, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Causal attention over a whole (right-padded) prompt batch that
    also returns its K/V (``repro.models.layers.attention_prefill``): x
    (B, S, d) -> (out (B, S, d), {"k", "v"} of (B, S, Hkv, D)), through
    the config's ``attn_impl`` dispatch (dense below S = 4096, the flash
    kernel from there)."""
    B, S, _ = x.shape
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    out = causal_attention(q, k, v, impl=cfg.attn_impl,
                           k_chunk=cfg.attn_chunk)
    return attn.project_out(out.reshape(B, S, cfg.q_dim)), {"k": k, "v": v}


def attention_decode(attn: Attention, x: torch.Tensor, cache: Cache,
                     cos: torch.Tensor, sin: torch.Tensor,
                     w: DenseWrite) -> torch.Tensor:
    """K-token decode/verify over dense rows
    (``repro.models.layers.attention_decode``), plain PyTorch as in JAX.

    x: (B, K, d).  Token t of row b is written at ``index[b] + t`` (or
    dropped past ``max_len``), then attends over the whole row under the
    mask ``pos <= index[b] + t``.  Scores are f32, as JAX's
    ``preferred_element_type=f32`` product: q and K are cast up before
    the product (exact for bf16), not multiplied in bf16 and rounded.
    The softmax weights are cast back to V's dtype for the second
    product, as in JAX.  Returns the attention output (B, K, d).
    """
    B, K, _ = x.shape
    cfg = attn.cfg
    q, k_new, v_new = attn.project_qkv(x, cos, sin)
    _write_rows(cache, k_new, v_new, w)
    k, v = cache["k"], cache["v"]
    S_max, Hkv, D = k.shape[1:]
    qh = q.reshape(B, K, Hkv, cfg.num_heads // Hkv, D)
    scores = torch.einsum("bthgd,bkhd->bthgk", qh.float(),
                          k.float()) / math.sqrt(D)
    pos = torch.arange(S_max, device=x.device)
    valid = pos[None, None, :] <= w.reach[..., None]             # (B, K, S)
    scores = scores.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthgk,bkhd->bthgd", p.to(v.dtype), v)
    return attn.project_out(out.reshape(B, K, cfg.q_dim))


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
    row's reach: once over the whole pool, or with ``w.shards`` > 1 once a
    data shard over its sub-pool (:func:`ops.paged_attention_sharded`).
    Returns the attention output (B, K, d).
    """
    B, K, _ = x.shape
    q, k_new, v_new = attn.project_qkv(x, cos, sin)
    _write_pages(cache, k_new, v_new, w)
    if w.shards > 1:
        out = ops.paged_attention_sharded(w.shards, q, cache["k"],
                                          cache["v"], w.tables, w.lengths)
    else:
        out = ops.paged_attention(q, cache["k"], cache["v"], w.tables,
                                  w.lengths)
    return attn.project_out(out.reshape(B, K, attn.cfg.q_dim))


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
    return attn.project_out(out.reshape(1, P, cfg.q_dim))


def attention_chunk_paged(attn: Attention, x: torch.Tensor, cache: Cache,
                          cos: torch.Tensor, sin: torch.Tensor,
                          w: PagedWrite) -> torch.Tensor:
    """One chunked-prefill slice of a single request over the paged pool.

    x: (1, C, d).  The chunk's K/V are scattered into the pool, then the
    chunk queries attend over the gathered pages of the request's table
    (history, prefix-shared pages and the chunk itself) under one
    absolute causal mask — plain PyTorch, as the JAX package does it.
    The gather reads the whole pool with global page ids, which holds on
    one device whatever the pool's data shards: this is the place where a
    card a shard would need the tables rebased too, as the decode's
    sharded dispatch rebases them.
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
    return attn.project_out(out.reshape(1, C, cfg.q_dim))


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
        # the model axis when this rank holds a cut of d_ff (``wi``/``wg``
        # column-parallel, ``wo`` row-parallel, its partial sums
        # all-reduced), as on :class:`Attention`
        self.tp = None


def mlp_block(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``silu(x Wg) * (x Wi)`` then ``Wo`` (summed over the model ranks
    when d_ff is cut across them)."""
    y = mlp.wo(F.silu(mlp.wg(x)) * mlp.wi(x))
    return y if mlp.tp is None else mlp.tp.all_reduce(y)


# ---------------------------------------------------------------------------
# Mixture of experts (shared + routed, fine-grained, capacity-based)
# ---------------------------------------------------------------------------

# tokens of one dispatch group: the largest divisor of a call's B * S up to
# this (``repro.models.layers.MOE_GROUP_TOKENS``' default)
MOE_GROUP_TOKENS = 1024
# profiler ranges around a MoE call's routing and its expert products: a
# profile of a step reads their device time under these names
MOE_ROUTE_RANGE = "moe.route"
MOE_EXPERTS_RANGE = "moe.experts"


class MoE(nn.Module):
    """Mixture-of-experts FFN weights (``repro.models.layers.init_moe``),
    kept in the JAX package's layout: ``router`` (d, E) in f32 whatever the
    model's dtype, the expert stacks ``wi`` and ``wg`` (E, d, d_e) and
    ``wo`` (E, d_e, d), and with ``num_shared_experts`` a SwiGLU ``shared``
    of width ``d_e * num_shared_experts`` that every token runs through.

    ``moe_block`` leaves the last call's dropped (token, choice) pairs
    (a 0-dim device tensor) and their total in ``routed``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        m = cfg.moe
        d, E = cfg.d_model, m.num_experts
        d_e = m.d_expert or cfg.d_ff
        self.cfg = cfg
        self.router = nn.Parameter(torch.empty((d, E), dtype=torch.float32))
        self.wi = nn.Parameter(torch.empty((E, d, d_e), dtype=dtype))
        self.wg = nn.Parameter(torch.empty((E, d, d_e), dtype=dtype))
        self.wo = nn.Parameter(torch.empty((E, d_e, d), dtype=dtype))
        if m.num_shared_experts:
            self.shared = MLP(d, d_e * m.num_shared_experts, dtype)
        self.routed = None

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Random weights from ``gen``: each N(0, 1/d_in), drawn in f32
        and cast (the router stays f32)."""
        for p in (self.router, self.wi, self.wg, self.wo):
            d_in = p.shape[-2]
            w = torch.randn(p.shape, generator=gen, device=gen.device,
                            dtype=torch.float32)
            p.copy_((w / math.sqrt(d_in)).to(p.dtype))
        if hasattr(self, "shared"):
            for lin in (self.shared.wi, self.shared.wg, self.shared.wo):
                lin.weight.copy_(dense_init(gen, lin.in_features,
                                            lin.out_features,
                                            lin.weight.dtype))


def moe_group_size(T: int) -> int:
    """Tokens of a dispatch group: the largest divisor of ``T`` that is at
    most :data:`MOE_GROUP_TOKENS`."""
    Tg = min(T, MOE_GROUP_TOKENS)
    while T % Tg:
        Tg -= 1
    return Tg


class Routing(NamedTuple):
    """A MoE call's routing over G groups of Tg tokens: ``logits`` and
    ``probs`` (G, Tg, E) f32; the top-k ``gate`` (renormalised, zero where
    dropped) and expert ``idx`` (G, Tg, k); each (token, choice)'s
    position ``pos`` in its expert's buffer, counted over the group in
    token-major order, ``keep = pos < capacity``; and ``density`` (E,),
    the share of tokens that chose each expert."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    density: torch.Tensor
    capacity: int


def route(moe: MoE, cfg: ModelConfig, xt: torch.Tensor,
          dropless: bool = False) -> Routing:
    """Top-k routing of ``xt`` (G, Tg, d), as ``moe_block`` in JAX: the
    logits are x times the router cast to x's dtype, accumulated and kept
    in f32 (``F.linear`` in bf16 would round them to bf16 and flip
    choices); softmax, top-k, renormalise; capacity ``max(1, int(cf * Tg
    * k / E))``, or Tg when ``dropless``, and the pairs past it
    dropped."""
    m = cfg.moe
    G, Tg, _ = xt.shape
    E, k = m.num_experts, m.top_k
    logits = torch.matmul(xt.float(), moe.router.to(xt.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    capacity = Tg if dropless else max(1, int(m.capacity_factor * Tg * k
                                              / E))
    onehot = F.one_hot(idx, E)                              # (G, Tg, k, E)
    flat = onehot.reshape(G, Tg * k, E)
    pos = ((flat.cumsum(1) - flat).reshape(G, Tg, k, E) * onehot).sum(-1)
    keep = pos < capacity
    density = onehot.amax(2).float().mean((0, 1))
    return Routing(logits, probs, gate * keep, idx, pos, keep, density,
                   capacity)


def moe_block(moe: MoE, cfg: ModelConfig, x: torch.Tensor,
              dropless: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Capacity-based top-k MoE over ``x`` (B, S, d), the function of
    ``repro.models.layers.moe_block``: returns (out (B, S, d), aux) with
    the Switch load-balance loss ``moe_load_balance`` and the router
    z-loss ``moe_z`` (f32 scalars).

    Both ``dispatch`` values compute one function, and one index-based
    dispatch serves both: each kept (token, choice) pair gets a row of the
    (E, G * C, d) expert buffers, every other row reads a zero row; the
    expert products run over the expert axis as three batched products
    (``gecd,edf->gecf`` in JAX); each token sums its kept choices' outputs
    weighted by their gates, then adds the shared experts'.  With
    ``dropless`` (the cached paths) the capacity is the group's size and
    no pair is dropped, so a token's output depends on it alone."""
    m = cfg.moe
    if m.dispatch not in ("einsum", "scatter"):
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}")
    B, S, d = x.shape
    T = B * S
    Tg = moe_group_size(T)
    G = T // Tg
    E, k = m.num_experts, m.top_k
    xt = x.reshape(G, Tg, d)
    with record_function(MOE_ROUTE_RANGE):
        r = route(moe, cfg, xt, dropless)
    C, dev = r.capacity, x.device
    cdt = torch_dtype(cfg)
    # row of each kept pair in the flat (E, G, C) buffers; the dropped
    # ones all land on one spare row past the end
    groups = torch.arange(G, device=dev)[:, None, None]
    row = torch.where(r.keep, (r.idx * G + groups) * C + r.pos, E * G * C)
    src = torch.full((E * G * C + 1,), T, dtype=torch.long, device=dev)
    src[row.reshape(-1)] = torch.arange(T, device=dev).repeat_interleave(k)
    x_pad = torch.cat([x.reshape(T, d).to(cdt),
                       x.new_zeros((1, d), dtype=cdt)])
    xe = x_pad[src[:-1]].reshape(E, G * C, d)
    with record_function(MOE_EXPERTS_RANGE):
        h = F.silu(torch.bmm(xe, moe.wg)) * torch.bmm(xe, moe.wi)
        ye = torch.bmm(h, moe.wo).reshape(E * G * C, d)
    picked = torch.cat([ye, ye.new_zeros((1, d))])[row]     # (G, Tg, k, d)
    out = torch.matmul(r.gate.to(cdt)[..., None, :], picked)[..., 0, :]
    if hasattr(moe, "shared"):
        out = out + mlp_block(moe.shared, xt)
    moe.routed = ((~r.keep).sum().detach(), G * Tg * k)
    aux = {"moe_load_balance": (r.density * r.probs.mean((0, 1))).sum() * E,
           "moe_z": torch.logsumexp(r.logits, dim=-1).square().mean()}
    return out.reshape(B, S, d), aux
