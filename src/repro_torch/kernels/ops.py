"""Device dispatch for the port's kernels — the model's only entry to them.

A tensor on the CPU takes the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a tensor on a CUDA device takes the
hand-written kernel, whose wrapper launches it or raises.  There is no
fallback from the card to the plain version.

The differentiable ops (:func:`rmsnorm`, :func:`flash_attention`,
:func:`mamba_scan`, :func:`slstm_scan`) are ``torch.autograd.Function``s
whose forward and backward both dispatch so: the CPU runs the same
autograd wiring as the card, with the plain versions in the kernels'
place.  The two scans' backward kernels have no TPU counterpart (the JAX
model differentiates their ``lax.scan`` twins); their forwards save what
the backwards read only when autograd records, so serving launches and
times them as before.
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


def paged_attention_sharded(shards: int, q: torch.Tensor,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            tables: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Paged attention over a pool split into ``shards`` private sub-pools
    (the serving mesh's ``data`` axis; JAX's ``paged_attention_sharded``,
    ``src/repro/kernels/ops.py:62``, without its ``model`` head split).

    The pool's pages are ``shards`` contiguous groups of ``pps + 1`` (each
    ending with its null page) and the batch ``shards`` contiguous groups
    of rows; every row's pages lie in its group's sub-pool, and ``tables``
    holds global page ids.  Shard ``i`` takes its rows, the view of its
    sub-pool (no copy) and its tables rebased to local ids, ``clip(t - i *
    (pps + 1), 0, pps)``, and runs :func:`paged_attention` on them: one
    kernel launch a shard on the card, the plain version on the CPU.  The
    outputs come back in row order.  A dispatch, not a kernel.
    """
    B, P = q.shape[0], k_pages.shape[0]
    if B % shards or P % shards:
        raise ValueError(
            f"paged_attention_sharded: batch {B} and pool pages {P} must "
            f"be divisible by the data shards ({shards})")
    rows, pages = B // shards, P // shards
    outs = []
    for i in range(shards):
        r = slice(i * rows, (i + 1) * rows)
        p = slice(i * pages, (i + 1) * pages)
        local = (tables[r] - i * pages).clamp(0, pages - 1)
        outs.append(paged_attention(q[r], k_pages[p], v_pages[p],
                                    local.to(torch.int32), lengths[r]))
    return torch.cat(outs, dim=0)


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


class _MambaScan(torch.autograd.Function):
    """Selective scan; on the card the forward, when ``keep``, also writes
    the state before every tile, from which the backward kernel
    recomputes each tile's states (the CPU's plain backward keeps its
    own)."""

    @staticmethod
    def forward(ctx, dt, xc, bm, cm, a, keep):
        args = tuple(t.contiguous() for t in (dt, xc, bm, cm, a))
        h_ckpt = None
        if dt.device.type == "cpu":
            y, h_last = ref.mamba_scan_ref(*args)
        else:
            if keep:
                h_ckpt = torch.empty(ms.ckpt_shape(args[0], args[4]),
                                     dtype=torch.float32, device=dt.device)
            y, h_last = ms.mamba_scan(*args, h_ckpt=h_ckpt)
        if keep:
            ctx.save_for_backward(*args, h_ckpt)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, xc, bm, cm, a, h_ckpt = ctx.saved_tensors
        dy, dh_last = dy.contiguous(), dh_last.contiguous()
        if dt.device.type == "cpu":
            grads = ref.mamba_scan_bwd_ref(dt, xc, bm, cm, a, dy, dh_last)
        else:
            grads = ms.mamba_scan_bwd(dt, xc, bm, cm, a, h_ckpt, dy,
                                      dh_last)
        return (*grads, None)


def _records(*tensors) -> bool:
    """True when autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mamba_scan(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor):
    """Selective scan -> (y, final state) (see ``ref.mamba_scan_ref``),
    differentiable in every input and through the final state: CPU ->
    the plain forward and backward, CUDA -> the CUDA kernels."""
    return _MambaScan.apply(dt, xc, bm, cm, a, _records(dt, xc, bm, cm, a))


class _SLSTMScan(torch.autograd.Function):
    """sLSTM recurrence; on the card the forward, when ``keep``, also
    writes every step's gates and ``(c, n, m)`` for the backward kernel
    (the CPU's plain backward runs the forward again)."""

    @staticmethod
    def forward(ctx, gx, r_h, keep):
        gx, r_h = gx.contiguous(), r_h.contiguous()
        if gx.device.type == "cpu":
            out, state = ref.slstm_ref(gx, r_h)
            saved = (gx,)
        else:
            saved = sl.residuals(gx) if keep else None
            out, state = sl.slstm_scan(gx, r_h, saved)
        if keep:
            ctx.save_for_backward(r_h, out, *saved)
        return (out, *state)

    @staticmethod
    def backward(ctx, dout, *d_final):
        r_h, out, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        d_final = tuple(t.contiguous() for t in d_final)
        if r_h.device.type == "cpu":
            d_gx, d_r_h = ref.slstm_bwd_ref(saved[0], r_h, dout, d_final)
        else:
            d_gx, d_r_h = sl.slstm_scan_bwd(r_h, out, saved, dout, d_final)
        return d_gx, d_r_h, None


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor):
    """sLSTM recurrence -> (h, (h, c, n, m) final) (see ``ref.slstm_ref``),
    differentiable in gx and r_h and through the final state: CPU -> the
    plain forward and backward, CUDA -> the CUDA kernels."""
    out, *state = _SLSTMScan.apply(gx, r_h, _records(gx, r_h))
    return out, tuple(state)
