"""Plain PyTorch versions of the port's kernels (the allclose references).

Each mirrors the jnp oracle of the same name in ``repro.kernels.ref``.  On
the CPU the model runs through these; on the card ``chip_smoke.py`` holds
each hand-written kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Gather-decode/verify attention over a paged KV pool.

    q: (B, H, D) single-token decode, or (B, K, H, D) for K consecutive
    query tokens per row; k_pages/v_pages: (P, bs, Hkv, D); tables: (B, W)
    physical page ids; lengths: (B,) valid KV tokens for the FIRST query
    of each row — query t sees ``lengths[b] + t`` tokens.  Gathers each
    row's pages into logical order and runs masked softmax attention in
    f32.  Returns q's rank and dtype.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, K, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    W = tables.shape[1]
    g = H // Hkv
    t = tables.long()
    kg = k_pages[t].reshape(B, W * bs, Hkv, D).float()
    vg = v_pages[t].reshape(B, W * bs, Hkv, D).float()
    qg = q.reshape(B, K, Hkv, g, D).float()
    s = torch.einsum("bthgd,bkhd->bthgk", qg, kg) / math.sqrt(D)
    pos = torch.arange(W * bs, device=q.device)
    lens = lengths.long()[:, None] + torch.arange(K, device=q.device)[None]
    valid = pos[None, None, :] < lens[..., None]          # (B, K, W*bs)
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bthgk,bkhd->bthgd", w, vg)
    out = out.reshape(B, K, H, D).to(q.dtype)
    return out[:, 0] if squeeze else out


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` over the last axis, with f32
    statistics, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
