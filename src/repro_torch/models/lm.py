"""Decoder LM of the port: embeds -> a ModuleList of blocks -> logits.

The counterpart of ``repro.models.lm`` for the dense (attention + SwiGLU),
hybrid (jamba: Mamba/attention interleave with dense FFNs) and ssm (xLSTM)
families.  The JAX package stacks each period's layer weights and drives
them with ``lax.scan``; here the layers are an ``nn.ModuleList`` walked in
a Python loop (:func:`param_groups` recovers JAX's stacking where an
optimizer needs it).  Five entry points:

  ``lm_forward``        full causal forward, no cache (training, and the
                        serve recompute yardstick), optionally
                        rematerialized per block
  ``lm_loss``           next-token cross entropy over ``lm_forward``
  ``lm_prefill``        one chunked-prefill slice of one request, scattered
                        into the paged pools (``_prefill_chunk`` in JAX;
                        attention-only stacks)
  ``lm_prefill_exact``  one request's whole prompt at its exact length:
                        attention K/V into its pages, recurrent state into
                        its slot row (JAX's one-shot prefill plus
                        ``insert_prefill``; any stack)
  ``lm_decode``         K >= 1 tokens per row over the paged pools (block
                        tables, per-row index with -1 for idle rows,
                        ``valid``); recurrent stacks take K = 1 and step
                        every slot row's state

The cached entry points write the pools and state rows **in place**; the
JAX package returns a new cache pytree each call and donates the old one.
The recurrent mixers' scans have no backward kernel, so a stack with a
recurrent layer runs without gradients only (training them is ROADMAP
queue A7).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X


class LayerSpec(NamedTuple):
    """Block kind ('a' attention, 'M' mamba, 'm' mLSTM, 's' sLSTM), FFN
    kind ('dense', 'moe' or 'none') and its width."""

    kind: str
    ffn: str
    d_ff: int


# the families the port serves: attention + SwiGLU, the jamba-style
# Mamba/attention hybrid, and xLSTM stacks
FAMILIES = ("dense", "hybrid", "ssm")
RECURRENT = ("M", "m", "s")


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """Per-layer specs (``repro.models.lm.layer_specs``): xLSTM stacks
    cycle ``xlstm.pattern`` with no FFN; the others cycle
    ``block_pattern`` with a dense FFN (or MoE where ``is_moe_layer``)."""
    if cfg.family == "cyclegan":
        raise ValueError(
            f"{cfg.name!r} is the CycleGAN surrogate, not an LM: it has no "
            "layer stack (repro_torch.models.icf_cyclegan)")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    if cfg.family == "ssm" and cfg.xlstm is not None:
        pat = cfg.xlstm.pattern
        return tuple(LayerSpec(pat[i % len(pat)], "none", 0)
                     for i in range(cfg.num_layers))
    specs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if cfg.moe is not None and cfg.is_moe_layer(i):
            ffn, d_ff = "moe", 0
        elif cfg.moe is not None and i < cfg.moe.first_k_dense:
            ffn, d_ff = "dense", (cfg.moe.dense_d_ff or cfg.d_ff)
        elif cfg.d_ff > 0:
            ffn, d_ff = "dense", cfg.d_ff
        else:
            ffn, d_ff = "none", 0
        specs.append(LayerSpec(kind, ffn, d_ff))
    return tuple(specs)


def has_recurrent(cfg: ModelConfig) -> bool:
    """Does the stack hold a recurrent (Mamba or xLSTM) layer?"""
    return any(s.kind in RECURRENT for s in layer_specs(cfg))


def grouping(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(k0 prefix layers, period length R, periods P) of the JAX package's
    stacked layout (``repro.models.lm._grouping``): layer ``k0 + p*R + j``
    is entry p of the JAX leaf ``body[j]``."""
    specs = layer_specs(cfg)
    k0 = cfg.moe.first_k_dense if cfg.moe is not None else 0
    pat_len = len(cfg.xlstm.pattern) if (cfg.family == "ssm"
                                         and cfg.xlstm) \
        else len(cfg.block_pattern)
    moe_p = cfg.moe.moe_period if (cfg.moe and cfg.moe.moe_period > 1) \
        else 1
    R = math.lcm(pat_len, moe_p)
    body = len(specs) - k0
    if body % R:
        raise ValueError(f"{cfg.name}: {body} body layers are not whole "
                         f"periods of {R}")
    return k0, R, body // R


def param_groups(cfg: ModelConfig, names: Iterable[str]
                 ) -> Dict[str, List[str]]:
    """The JAX package's parameter leaves over the port's per-layer names
    (given in a model's parameter order, i.e. layer order): ``{key: member
    names}``, members in stack order.

    JAX stacks each weight of the layers ``j + p*R`` (p = 0 .. P-1) into
    one leaf ``body[j]``; the group key is ``"blocks[j::R].<name>"``.  A
    weight outside the blocks is a group of its own under its own name.
    Leaf-wise optimizers (Adafactor) read these to clip and factor as JAX
    does.  (JAX's separate stack of k0 dense prefix layers comes only with
    MoE, which the port does not build yet.)
    """
    _, R, _ = grouping(cfg)
    groups: Dict[str, List[str]] = {}
    for name in names:
        if not name.startswith("blocks."):
            groups[name] = [name]
            continue
        _, i, rest = name.split(".", 2)
        groups.setdefault(f"blocks[{int(i) % R}::{R}].{rest}",
                          []).append(name)
    return groups


_MIXERS = {"a": L.Attention, "M": S.Mamba, "m": X.MLSTM, "s": X.SLSTM}


class Block(nn.Module):
    """Pre-norm block: ``ln1``, the mixer of ``spec.kind`` and, with a
    dense FFN, ``ln2`` and the SwiGLU ``ffn``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 dtype: torch.dtype):
        super().__init__()
        if spec.ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE FFN layers are not ported to repro_torch "
                "yet; see ROADMAP.md queue A8 (MoE FFN)")
        self.kind = spec.kind
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
        self.mixer = _MIXERS[spec.kind](cfg, dtype)
        if spec.ffn == "dense":
            self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
            self.ffn = L.MLP(cfg.d_model, spec.d_ff, dtype)


class LM(nn.Module):
    """Weights of a decoder LM (use :func:`init_lm` to build one)."""

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

    As in ``repro.models.lm.init_lm``: dense weights N(0, 1/d_in), the
    embedding N(0, 0.02^2), norm scales one and biases zero; the Mamba and
    xLSTM mixers draw their own (``init_weights``: ``A_log``, ``dt_bias``,
    ``D``, the conv, the gate biases, ``r_h``).  The numbers differ from
    JAX's (another generator), so parity tests load the JAX weights
    through :mod:`repro_torch.bridge`.  A MoE layer raises.
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
        own = []
        for i, block in enumerate(model.blocks):
            if hasattr(block.mixer, "init_weights"):
                block.mixer.init_weights(gen)
                own.append(f"blocks.{i}.mixer.")
        for name, p in model.named_parameters():
            if name.startswith(tuple(own)):
                continue
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


def init_cache(cfg: ModelConfig, pages: Tuple[int, int], num_slots: int = 0,
               device="cuda") -> List[L.Cache]:
    """Per-layer decode cache (``repro.models.lm.init_cache`` with
    ``pages``): an attention layer gets one shared paged KV pool,
    ``pages=(num_pages, block_size)``, each ``(num_pages + 1, block_size,
    Hkv, D)`` with the null page last; a recurrent layer keeps
    ``num_slots`` dense state rows, one per decode slot (Mamba ``ssm`` and
    ``conv``; mLSTM ``C``, ``n``, ``m``; sLSTM ``h``, ``c``, ``n``,
    ``m``)."""
    dev = resolve_device(device)
    num_pages, block_size = pages
    dt = L.torch_dtype(cfg)
    specs = layer_specs(cfg)
    if num_slots < 1 and any(s.kind in RECURRENT for s in specs):
        raise ValueError("a stack with recurrent layers needs num_slots "
                         ">= 1 state rows")
    make = {
        "a": lambda: L.init_paged_attention_cache(cfg, num_pages,
                                                  block_size, dev),
        "M": lambda: S.init_mamba_state(cfg, num_slots, dt, dev),
        "m": lambda: X.init_mlstm_state(cfg, num_slots, dev),
        "s": lambda: X.init_slstm_state(cfg, num_slots, dev)}
    return [make[s.kind]() for s in specs]


_FULL_SEQUENCE = {"M": S.mamba_core, "m": X.mlstm_block, "s": X.slstm_block}
_DECODE = {"M": S.mamba_decode, "m": X.mlstm_decode, "s": X.slstm_decode}


def _apply_block(block: Block, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, mode: str, cache: Optional[L.Cache] = None,
                 write: Optional[L.PagedWrite] = None,
                 slot: Optional[int] = None) -> torch.Tensor:
    """One block in mode ``train`` (no cache), ``prefill`` (one request's
    whole prompt at exact length: attention K/V into its pages, recurrent
    state into its slot row ``slot``), ``chunk`` (chunked prefill,
    attention only) or ``decode`` (one token per row over every slot);
    returns the new residual.  Caches are written in place."""
    h = block.ln1(x)
    if block.kind == "a":
        if mode == "train":
            mix = L.attention_block(block.mixer, h, cos, sin)
        elif mode == "prefill":
            mix = L.attention_prefill_paged(block.mixer, h, cache, cos, sin,
                                            write)
        elif mode == "chunk":
            mix = L.attention_chunk_paged(block.mixer, h, cache, cos, sin,
                                          write)
        elif mode == "decode":
            mix = L.attention_decode_paged(block.mixer, h, cache, cos, sin,
                                           write)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    elif mode in ("train", "prefill"):
        mix, state = _FULL_SEQUENCE[block.kind](block.mixer, h)
        if mode == "prefill":
            for k, v in state.items():
                cache[k][slot] = v[0]
    elif mode == "decode":
        mix, state = _DECODE[block.kind](block.mixer, h, cache)
        for k, v in state.items():
            cache[k].copy_(v)
    else:
        raise ValueError(f"mode {mode!r} takes attention blocks only (got "
                         f"mixer kind {block.kind!r})")
    x = x + mix
    if hasattr(block, "ffn"):
        x = x + L.mlp_block(block.ffn, block.ln2(x))
    return x


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x)
    if model.cfg.tie_embeddings:
        return F.linear(x, model.embed.weight)
    return model.lm_head(x)


def _rope(model: LM, positions: torch.Tensor):
    cfg = model.cfg
    return L.rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


REMAT = ("none", "full", "dots", "dots_no_batch")


def lm_forward(model: LM, tokens: torch.Tensor,
               remat: str = "none") -> torch.Tensor:
    """Full causal forward without a cache: tokens (B, S) -> logits
    (B, S, V).  Attention follows the config's ``attn_impl`` (dense below
    S = 4096, flash from there); no pages, no paged kernel.

    ``remat="full"`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), the granularity of JAX's
    ``_remat_wrap``: only the blocks' inputs are kept.  It takes effect
    only where autograd records.  JAX's ``"dots"`` policies, which save the
    matmul outputs, are not ported.
    """
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; one of {REMAT}")
    if remat in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A")
    if torch.is_grad_enabled() and has_recurrent(model.cfg):
        raise NotImplementedError(
            f"{model.cfg.name}: training the recurrent families is not "
            "ported yet (the scan kernels have no backward); see ROADMAP.md "
            "queue A7")
    x = model.embed(tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cos, sin = _rope(model, positions)
    recompute = remat == "full" and torch.is_grad_enabled()
    for block in model.blocks:
        if recompute:
            x = checkpoint(_apply_block, block, x, cos, sin, "train",
                           use_reentrant=False)
        else:
            x = _apply_block(block, x, cos, sin, "train")
    return _logits(model, x)


def lm_loss(model: LM, batch: Dict[str, torch.Tensor],
            remat: str = "none") -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """Next-token cross entropy (``repro.models.lm.lm_loss``, dense
    family): logits in f32, ``logsumexp`` minus the gold logit, averaged
    over the positions whose label is ``>= 0``.  ``batch`` holds
    ``tokens`` and ``labels``, (B, S) integer tensors on the model's
    device.  Returns (loss, {"ce": loss})."""
    logits = lm_forward(model, batch["tokens"], remat)
    labels = batch["labels"].long()
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    return ce, {"ce": ce}


def _pool_geometry(cache: List[L.Cache]) -> Optional[Tuple[int, int]]:
    """(null page, block size) of the paged pools, or None for a stack
    without attention layers (no pools)."""
    pool = next((c["k"] for c in cache if "k" in c), None)
    return None if pool is None else (pool.shape[0] - 1, pool.shape[1])


@torch.no_grad()
def lm_prefill(model: LM, tokens: torch.Tensor, cache: List[L.Cache],
               tables: torch.Tensor, hist_len: int, prompt_len: int,
               last_pos: int) -> torch.Tensor:
    """One chunked-prefill slice for a single request, into the pools.

    tokens: (1, C) prompt positions ``[hist_len, hist_len + C)``, the tail
    chunk right-padded past ``prompt_len``; tables: (1, W) int32, the
    request's block-table row; last_pos: position WITHIN the chunk whose
    logits are returned (meaningful on the final chunk).  Attention-only
    stacks: a recurrent layer raises.  Returns logits (1, 1, V).
    """
    if has_recurrent(model.cfg):
        raise ValueError(
            f"{model.cfg.name}: chunked prefill requires an attention-only "
            "stack; recurrent state cannot resume mid-prompt")
    _, C = tokens.shape
    null_page, bs = _pool_geometry(cache)
    write = L.chunk_write(hist_len, prompt_len, C, tables, bs, null_page)
    positions = hist_len + torch.arange(C, device=tokens.device)[None]
    cos, sin = _rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x = _apply_block(block, x, cos, sin, "chunk", layer_cache, write)
    return _logits(model, x[:, last_pos:last_pos + 1])


@torch.no_grad()
def lm_prefill_exact(model: LM, tokens: torch.Tensor, cache: List[L.Cache],
                     tables: Optional[torch.Tensor], slot: int
                     ) -> torch.Tensor:
    """One request's whole prompt at its exact length, no padding.

    tokens: (1, P), the prompt; tables: (1, W) int32, the request's
    block-table row covering its P positions (ignored by a stack without
    attention layers); slot: the request's decode row.  Attention layers
    write the prompt's K/V into the request's pages and attend causally
    over the prompt; recurrent layers run their full-sequence path and
    write the state after the P real steps into row ``slot``.  The JAX
    package builds a dense prefill cache and scatters it
    (``kv_cache.insert_prefill``); the pools and rows end up the same.
    Returns the last position's logits (1, 1, V).
    """
    _, P = tokens.shape
    geometry = _pool_geometry(cache)
    write = None if geometry is None else \
        L.chunk_write(0, P, P, tables, geometry[1], geometry[0])
    positions = torch.arange(P, device=tokens.device)[None]
    cos, sin = _rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x = _apply_block(block, x, cos, sin, "prefill", layer_cache, write,
                         slot)
    return _logits(model, x[:, -1:])


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
    A stack with recurrent layers takes K = 1 and no ``valid`` (the
    K-token verify on recurrent rows is ROADMAP queue A7), with one row
    per slot: every row's state steps, an idle row's too (it is garbage
    until an admission overwrites it, as in JAX).  Returns logits
    (B, K, V).
    """
    B, K = tokens.shape
    if has_recurrent(model.cfg) and (K != 1 or valid is not None):
        raise NotImplementedError(
            f"{model.cfg.name}: K-token verify over recurrent state is not "
            "ported yet; see ROADMAP.md queue A7")
    geometry = _pool_geometry(cache)
    write = None if geometry is None else \
        L.decode_write(index, tables, geometry[1], geometry[0], K, valid)
    positions = index.clamp(min=0)[:, None] \
        + torch.arange(K, device=tokens.device)[None]
    cos, sin = _rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x = _apply_block(block, x, cos, sin, "decode", layer_cache, write)
    return _logits(model, x)
