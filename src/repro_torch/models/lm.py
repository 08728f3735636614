"""Decoder LM of the port: embeds -> a ModuleList of blocks -> tied logits.

The counterpart of ``repro.models.lm`` for the dense family.  The JAX
package stacks each period's layer weights and drives them with
``lax.scan``; here the layers are an ``nn.ModuleList`` walked in a Python
loop.  Three entry points:

  ``lm_forward``   full causal forward, no cache (the recompute yardstick)
  ``lm_prefill``   one chunked-prefill slice of one request, scattered
                   into the paged pools (``_prefill_chunk`` in JAX)
  ``lm_decode``    K >= 1 tokens per row over the paged pools (block
                   tables, per-row index with -1 for idle rows, ``valid``)

Both cached entry points write the pools **in place**; the JAX package
returns a new pool pytree each call and donates the old one.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class LayerSpec(NamedTuple):
    """Block kind ('a' attention), FFN kind ('dense') and its width."""

    kind: str
    ffn: str
    d_ff: int


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Per-layer specs; the port serves the dense family only."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    return tuple(LayerSpec("a", "dense", cfg.d_ff)
                 for _ in range(cfg.num_layers))


class Block(nn.Module):
    """Pre-norm attention + SwiGLU block (``ln1, mixer, ln2, ffn``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 dtype: torch.dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
        self.mixer = L.Attention(cfg, dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
        self.ffn = L.MLP(cfg.d_model, spec.d_ff, dtype)


class LM(nn.Module):
    """Weights of a dense decoder LM (use :func:`init_lm` to build one)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = L.torch_dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dt)
        self.blocks = nn.ModuleList(Block(cfg, spec, dt)
                                    for spec in layer_specs(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size,
                                     bias=False, dtype=dt)

    @property
    def device(self) -> torch.device:
        """Device of the weights."""
        return self.embed.weight.device


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights from ``seed`` through a ``torch.Generator`` on
    ``device`` (the card unless the caller asks for ``"cpu"``).

    Dense weights are N(0, 1/d_in), the embedding N(0, 0.02^2), norm
    scales one and biases zero, as in ``repro.models.lm.init_lm``; the
    numbers differ from JAX's (another generator), so parity tests load
    the JAX weights through :mod:`repro_torch.bridge`.
    """
    dev = resolve_device(device)
    # built on the device itself, not on "meta": a module's default init
    # on meta goes through torch._refs, whose first call imports
    # torch._dynamo (seconds of host time) for weights overwritten below
    with torch.device(dev):
        model = LM(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "embed.weight":
                p.copy_(L.embed_init(gen, *p.shape, p.dtype))
            else:
                d_out, d_in = p.shape
                p.copy_(L.dense_init(gen, d_in, d_out, p.dtype))
    return model.eval()


def init_cache(cfg: ModelConfig, pages: Tuple[int, int],
               device="cuda") -> List[L.Cache]:
    """One shared paged KV pool per layer, ``pages=(num_pages,
    block_size)``: each ``(num_pages + 1, block_size, Hkv, D)`` with the
    null page last."""
    dev = resolve_device(device)
    num_pages, block_size = pages
    return [L.init_paged_attention_cache(cfg, num_pages, block_size, dev)
            for _ in layer_specs(cfg)]


def _apply_block(block: Block, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, mode: str, cache: Optional[L.Cache] = None,
                 write: Optional[L.PagedWrite] = None) -> torch.Tensor:
    """One block in mode ``train`` (no cache), ``chunk`` (chunked prefill)
    or ``decode`` (paged decode/verify); returns the new residual."""
    h = block.ln1(x)
    if mode == "train":
        mix = L.attention_block(block.mixer, h, cos, sin)
    elif mode == "chunk":
        mix = L.attention_chunk_paged(block.mixer, h, cache, cos, sin, write)
    elif mode == "decode":
        mix = L.attention_decode_paged(block.mixer, h, cache, cos, sin,
                                       write)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + mix
    return x + L.mlp_block(block.ffn, block.ln2(x))


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x)
    if model.cfg.tie_embeddings:
        return F.linear(x, model.embed.weight)
    return model.lm_head(x)


def _rope(model: LM, positions: torch.Tensor):
    cfg = model.cfg
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def lm_forward(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward without a cache: tokens (B, S) -> logits
    (B, S, V).  Dense attention, no pages, no paged kernel."""
    x = model.embed(tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cos, sin = _rope(model, positions)
    for block in model.blocks:
        x = _apply_block(block, x, cos, sin, "train")
    return _logits(model, x)


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, cache: List[L.Cache],
               tables: torch.Tensor, hist_len: int, prompt_len: int,
               last_pos: int) -> torch.Tensor:
    """One chunked-prefill slice for a single request, into the pools.

    tokens: (1, C) prompt positions ``[hist_len, hist_len + C)``, the tail
    chunk right-padded past ``prompt_len``; tables: (1, W) int32, the
    request's block-table row; last_pos: position WITHIN the chunk whose
    logits are returned (meaningful on the final chunk).  Returns logits
    (1, 1, V).
    """
    _, C = tokens.shape
    null_page = cache[0]["k"].shape[0] - 1
    bs = cache[0]["k"].shape[1]
    write = L.chunk_write(hist_len, prompt_len, C, tables, bs, null_page)
    positions = hist_len + torch.arange(C, device=tokens.device)[None]
    cos, sin = _rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x = _apply_block(block, x, cos, sin, "chunk", layer_cache, write)
    return _logits(model, x[:, last_pos:last_pos + 1])


@torch.no_grad()
def lm_decode(model: LM, tokens: torch.Tensor, cache: List[L.Cache],
              index: torch.Tensor, tables: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode/verify step over K >= 1 tokens per row, paged pools.

    tokens: (B, K); index: (B,) write position of each row's first token
    (its current KV length), -1 for an idle row; tables: (B, W) int32
    block tables; valid: optional (B,) count of real tokens per row
    (tokens past it write to the null page).  Token t of row b lands at
    ``index[b] + t`` and attends over positions ``<= index[b] + t``.
    Returns logits (B, K, V).
    """
    B, K = tokens.shape
    null_page = cache[0]["k"].shape[0] - 1
    bs = cache[0]["k"].shape[1]
    write = L.decode_write(index, tables, bs, null_page, K, valid)
    positions = index.clamp(min=0)[:, None] \
        + torch.arange(K, device=tokens.device)[None]
    cos, sin = _rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x = _apply_block(block, x, cos, sin, "decode", layer_cache, write)
    return _logits(model, x)
