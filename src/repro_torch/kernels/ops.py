"""Device dispatch for the port's kernels — the model's only entry to them.

A tensor on the CPU takes the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a tensor on a CUDA device takes the
hand-written kernel, whose wrapper launches it or raises.  There is no
fallback from the card to the plain version.

The differentiable ops (:func:`rmsnorm`, :func:`flash_attention`) are
``torch.autograd.Function``s whose forward and backward both dispatch so:
the CPU runs the same autograd wiring as the card, with the plain
versions in the kernels' place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import slstm as sl


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode/verify attention over paged KV (see ``ref.paged_attention_ref``
    for the contract): CPU -> plain version, CUDA -> the CUDA kernel."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths)
    return pa.paged_attention(q, k_pages, v_pages, tables, lengths)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the Triton forward and backward kernels on the card."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x, scale = x.contiguous(), scale.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return ref.rmsnorm_ref(x, scale, eps)
        return rn.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        else:
            dx, dscale = rn.rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable in x and scale: CPU ->
    plain versions, CUDA -> the Triton forward and backward kernels."""
    return _RMSNorm.apply(x, scale, eps)


class _FlashAttention(torch.autograd.Function):
    """Flash attention saving (q, k, v, out, lse), the residuals of JAX's
    ``_flash_vjp_fwd``; the backward recomputes P from ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, k_chunk):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cpu":
            out, lse = ref.flash_attention_fwd_ref(q, k, v, causal, k_chunk)
        else:
            out, lse = fa.flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.k_chunk = causal, k_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        args = (q, k, v, out, lse, dout.contiguous(), ctx.causal)
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_bwd_ref(*args, ctx.k_chunk)
        else:
            dq, dk, dv = fa.flash_attention_bwd(*args)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, k_chunk: int = 1024) -> torch.Tensor:
    """Causal (or full) GQA attention, q (B, S, H, D) and k/v (B, S, Hkv,
    D) -> (B, S, H, D), differentiable in q, k and v: CPU -> the plain
    chunked versions, CUDA -> the CUDA forward and backward kernels."""
    return _FlashAttention.apply(q, k, v, causal, k_chunk)


def mamba_scan(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor):
    """Selective scan -> (y, final state) (see ``ref.mamba_scan_ref``):
    CPU -> plain version, CUDA -> the CUDA kernel.  Forward only: neither
    it nor the TPU kernel has a backward."""
    if dt.device.type == "cpu":
        return ref.mamba_scan_ref(dt, xc, bm, cm, a)
    return ms.mamba_scan(dt, xc, bm, cm, a)


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor):
    """sLSTM recurrence -> (h, (h, c, n, m) final) (see ``ref.slstm_ref``):
    CPU -> plain version, CUDA -> the CUDA kernel.  Forward only: neither
    it nor the TPU kernel has a backward."""
    if gx.device.type == "cpu":
        return ref.slstm_ref(gx, r_h)
    return sl.slstm_scan(gx, r_h)
