"""Decoder LM of the port: embeds -> a ModuleList of blocks -> logits.

The counterpart of ``repro.models.lm`` for every LM family: dense and moe
(attention + SwiGLU or mixture of experts), hybrid (jamba: Mamba/attention
interleave, dense or MoE FFNs), ssm (xLSTM), and the vlm and audio
backbones behind their stub frontends (a vlm batch carries ``embeds`` and
(3, B, S) M-RoPE ``positions``; audio reads folded codebook token ids).
The JAX package stacks each period's layer weights (after a separate stack
of ``first_k_dense`` prefix layers) and drives them with ``lax.scan``;
here the layers are an ``nn.ModuleList`` walked in a Python loop
(:func:`param_groups` recovers JAX's stacking where an optimizer needs
it).  Five entry points:

  ``lm_forward``        full causal forward, no cache (training, and the
                        serve recompute yardstick), optionally
                        rematerialized per block; MoE layers run with
                        capacity, or dropless on request
  ``lm_loss``           next-token cross entropy over ``lm_forward`` plus
                        the MoE aux losses
  ``lm_prefill``        one chunked-prefill slice of one request, scattered
                        into the paged pools (``_prefill_chunk`` in JAX;
                        attention-only stacks)
  ``lm_prefill_exact``  one request's whole prompt at its exact length:
                        attention K/V into its pages, recurrent state into
                        its slot row (JAX's one-shot prefill plus
                        ``insert_prefill``; any stack)
  ``lm_decode``         K >= 1 tokens per row over the paged pools (block
                        tables, per-row index with -1 for idle rows,
                        ``valid``); recurrent layers step every slot row's
                        state token by token, freezing a row past its
                        ``valid`` tokens (the speculative verify and the
                        rollback replay)

The cached entry points run MoE layers dropless, as JAX's prefill and
decode do, and broadcast text positions to the three M-RoPE components.
They write the pools and state rows **in place**; the JAX package returns
a new cache pytree each call and donates the old one.
Every stack trains: the recurrent mixers' scans carry gradients through
their backward kernels (``kernels/ops.py``), and ``remat="full"`` runs a
recurrent block's scan forward again inside the backward.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
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


# the LM families: attention + SwiGLU or MoE, the jamba-style
# Mamba/attention hybrid, xLSTM stacks, and the stub-frontend backbones
FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
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
        raise ValueError(f"unknown family {cfg.family!r}; one of "
                         f"{FAMILIES}")
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


def group_key(cfg: ModelConfig, layer: int, rest: str) -> str:
    """The key of the JAX leaf that holds weight ``rest`` of ``layer``:
    ``"blocks[0:k0].<rest>"`` for a layer of the prefix stack (the
    ``first_k_dense`` layers, JAX's ``prefix``), else
    ``"blocks[k0+j::R].<rest>"`` for body position j (JAX's ``body[j]``,
    layers ``k0 + j + p*R``)."""
    k0, R, _ = grouping(cfg)
    if layer < k0:
        return f"blocks[0:{k0}].{rest}"
    return f"blocks[{k0 + (layer - k0) % R}::{R}].{rest}"


def param_groups(cfg: ModelConfig, names: Iterable[str]
                 ) -> Dict[str, List[str]]:
    """The JAX package's parameter leaves over the port's per-layer names
    (given in a model's parameter order, i.e. layer order): ``{key: member
    names}`` (keys from :func:`group_key`), members in stack order.

    JAX stacks the ``first_k_dense`` prefix layers into one leaf each
    (``prefix``) and each weight of the layers ``k0 + j + p*R`` (p = 0 ..
    P-1) into one leaf ``body[j]``.  A weight outside the blocks is a
    group of its own under its own name.  Leaf-wise optimizers (Adafactor)
    read these to clip and factor as JAX does, an expert stack (P, E, d,
    d_e) as one leaf.
    """
    groups: Dict[str, List[str]] = {}
    for name in names:
        if not name.startswith("blocks."):
            groups[name] = [name]
            continue
        _, i, rest = name.split(".", 2)
        groups.setdefault(group_key(cfg, int(i), rest), []).append(name)
    return groups


_MIXERS = {"a": L.Attention, "M": S.Mamba, "m": X.MLSTM, "s": X.SLSTM}


class Block(nn.Module):
    """Pre-norm block: ``ln1``, the mixer of ``spec.kind`` and, with an
    FFN, ``ln2`` and the SwiGLU or MoE ``ffn`` (``spec.ffn``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 dtype: torch.dtype):
        super().__init__()
        self.kind = spec.kind
        self.ffn_kind = spec.ffn
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
        self.mixer = _MIXERS[spec.kind](cfg, dtype)
        if spec.ffn != "none":
            self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype)
            self.ffn = L.MoE(cfg, dtype) if spec.ffn == "moe" \
                else L.MLP(cfg.d_model, spec.d_ff, dtype)


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
    xLSTM mixers and the MoE FFNs draw their own (``init_weights``:
    ``A_log``, ``dt_bias``, ``D``, the conv, the gate biases, ``r_h``; the
    f32 router and the expert stacks).  The numbers differ from JAX's
    (another generator), so parity tests load the JAX weights through
    :mod:`repro_torch.bridge`.
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
            for part in ("mixer", "ffn"):
                module = getattr(block, part, None)
                if hasattr(module, "init_weights"):
                    module.init_weights(gen)
                    own.append(f"blocks.{i}.{part}.")
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
_DECODE_MULTI = {"M": S.mamba_decode_multi, "m": X.mlstm_decode_multi,
                 "s": X.slstm_decode_multi}
# profiler range around an attention mixer (projections, RoPE, the cache
# writes and the attention kernel): a profile reads its device time here
ATTENTION_RANGE = "attention"


def _apply_block(block: Block, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, mode: str, cache: Optional[L.Cache] = None,
                 write: Optional[L.PagedWrite] = None,
                 slot: Optional[int] = None, dropless: bool = False,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One block in mode ``train`` (no cache), ``prefill`` (one request's
    whole prompt at exact length: attention K/V into its pages, recurrent
    state into its slot row ``slot``), ``chunk`` (chunked prefill,
    attention only) or ``decode`` (K >= 1 tokens per row over every slot;
    with K > 1 or ``valid`` a recurrent mixer steps token by token and
    freezes row b after its first ``valid[b]`` tokens, as JAX's
    ``_apply_block`` routes to the ``_multi`` decodes); returns the new
    residual and, for a MoE FFN, its aux losses (else None).  A MoE FFN
    runs with capacity in mode ``train`` unless ``dropless``, and
    dropless in the cached modes, as JAX's ``_apply_block`` does.  Caches
    are written in place."""
    h = block.ln1(x)
    if block.kind == "a":
        with record_function(ATTENTION_RANGE):
            mix = _attention(block.mixer, h, cos, sin, mode, cache, write)
    elif mode in ("train", "prefill"):
        mix, state = _FULL_SEQUENCE[block.kind](block.mixer, h)
        if mode == "prefill":
            for k, v in state.items():
                cache[k][slot] = v[0]
    elif mode == "decode":
        if h.shape[1] > 1 or valid is not None:
            mix, state = _DECODE_MULTI[block.kind](block.mixer, h, cache,
                                                   valid)
        else:
            mix, state = _DECODE[block.kind](block.mixer, h, cache)
        for k, v in state.items():
            cache[k].copy_(v)
    else:
        raise ValueError(f"mode {mode!r} takes attention blocks only (got "
                         f"mixer kind {block.kind!r})")
    x = x + mix
    aux = None
    if block.ffn_kind == "moe":
        f, aux = L.moe_block(block.ffn, block.ffn.cfg, block.ln2(x),
                             dropless=dropless or mode != "train")
        x = x + f
    elif block.ffn_kind == "dense":
        x = x + L.mlp_block(block.ffn, block.ln2(x))
    return x, aux


def _attention(attn: L.Attention, h: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, mode: str, cache: Optional[L.Cache],
               write: Optional[L.PagedWrite]) -> torch.Tensor:
    if mode == "train":
        return L.attention_block(attn, h, cos, sin)
    if mode == "prefill":
        return L.attention_prefill_paged(attn, h, cache, cos, sin, write)
    if mode == "chunk":
        return L.attention_chunk_paged(attn, h, cache, cos, sin, write)
    if mode == "decode":
        return L.attention_decode_paged(attn, h, cache, cos, sin, write)
    raise ValueError(f"unknown mode {mode!r}")


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x)
    if model.cfg.tie_embeddings:
        return F.linear(x, model.embed.weight)
    return model.lm_head(x)


def _rope(model: LM, positions: torch.Tensor):
    """cos/sin tables for ``positions``: (3, B, S) through M-RoPE, or
    (B, S) (the first component of a (3, B, S) one, as JAX reads it)
    through plain RoPE."""
    cfg = model.cfg
    hd = cfg.resolved_head_dim
    if cfg.use_mrope:
        return L.mrope_cos_sin(positions, hd, cfg.rope_theta,
                               cfg.frontend.mrope_sections)
    if positions.dim() == 3:
        positions = positions[0]
    return L.rope_cos_sin(positions, hd, cfg.rope_theta)


def _text_rope(model: LM, positions: torch.Tensor):
    """Tables for text positions (B, S) of the cached entry points: with
    M-RoPE all three components advance together (JAX's ``lm_decode`` and
    ``_prefill_chunk`` broadcast them)."""
    if model.cfg.use_mrope:
        positions = positions[None].expand(3, *positions.shape)
    return _rope(model, positions)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_load_balance", "moe_z")}


REMAT = ("none", "full", "dots", "dots_no_batch")


def lm_forward(model: LM, tokens: Optional[torch.Tensor],
               remat: str = "none", *, embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None,
               dropless: bool = False, with_aux: bool = False):
    """Full causal forward without a cache: tokens (B, S) -> logits
    (B, S, V).  Attention follows the config's ``attn_impl`` (dense below
    S = 4096, flash from there); no pages, no paged kernel.

    ``embeds`` (B, S, d) replaces the token embedding (the vlm stub
    frontend's patch embeddings, cast to the model's dtype; ``tokens`` is
    then unused) and ``positions`` the default ``arange(S)``: (B, S), or
    (3, B, S) for M-RoPE, which a ``use_mrope`` config requires (JAX's
    ``apply_mrope`` fails on (B, S) ones too).  MoE layers run with
    capacity, as JAX's ``lm_forward`` does, or with ``dropless`` as its
    cached paths do (the serve recompute yardstick).  ``with_aux``
    returns (logits, aux), aux the MoE losses summed over layers.

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
    cfg = model.cfg
    x = model.embed(tokens) if embeds is None \
        else embeds.to(L.torch_dtype(cfg))
    B, S = x.shape[:2]
    if positions is None:
        if cfg.use_mrope:
            raise ValueError(f"{cfg.name}: M-RoPE needs explicit (3, B, S) "
                             "positions")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cos, sin = _rope(model, positions)
    recompute = remat == "full" and torch.is_grad_enabled()
    aux = _zero_aux(x.device)
    for block in model.blocks:
        if recompute:
            x, a = checkpoint(_apply_block, block, x, cos, sin, "train",
                              dropless=dropless, use_reentrant=False)
        else:
            x, a = _apply_block(block, x, cos, sin, "train",
                                dropless=dropless)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    logits = _logits(model, x)
    return (logits, aux) if with_aux else logits


def lm_loss(model: LM, batch: Dict[str, torch.Tensor],
            remat: str = "none") -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """Next-token cross entropy plus the MoE aux losses
    (``repro.models.lm.lm_loss``): logits in f32, ``logsumexp`` minus the
    gold logit, averaged over the positions whose label is ``>= 0``; with
    MoE ``router_aux_weight * moe_load_balance + router_z_weight *
    moe_z`` added.  ``batch`` holds ``labels`` (B, S) and ``tokens`` (B,
    S), or, for a vlm, ``embeds`` (B, S, d) and ``positions`` (3, B, S),
    tensors on the model's device.  Returns (loss, {"ce", "moe_load_balance",
    "moe_z"}), the aux losses zero without MoE layers."""
    logits, aux = lm_forward(model, batch.get("tokens"), remat,
                             embeds=batch.get("embeds"),
                             positions=batch.get("positions"), with_aux=True)
    labels = batch["labels"].long()
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
    loss = ce
    moe = model.cfg.moe
    if moe is not None:
        loss = loss + moe.router_aux_weight * aux["moe_load_balance"] \
            + moe.router_z_weight * aux["moe_z"]
    return loss, {"ce": ce, **aux}


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
    cos, sin = _text_rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x, _ = _apply_block(block, x, cos, sin, "chunk", layer_cache, write)
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
    cos, sin = _text_rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x, _ = _apply_block(block, x, cos, sin, "prefill", layer_cache,
                            write, slot)
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
    A stack with recurrent layers takes one row per slot: every row's
    state steps through the K tokens in order and, with ``valid``, stops
    after row b's first ``valid[b]`` (an idle row without ``valid`` steps
    too: it is garbage until an admission overwrites it, as in JAX).
    Returns logits (B, K, V).
    """
    K = tokens.shape[1]
    geometry = _pool_geometry(cache)
    write = None if geometry is None else \
        L.decode_write(index, tables, geometry[1], geometry[0], K, valid)
    positions = index.clamp(min=0)[:, None] \
        + torch.arange(K, device=tokens.device)[None]
    cos, sin = _text_rope(model, positions)
    x = model.embed(tokens)
    for block, layer_cache in zip(model.blocks, cache):
        x, _ = _apply_block(block, x, cos, sin, "decode", layer_cache, write,
                            valid=valid)
    return _logits(model, x)
