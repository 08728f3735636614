"""Fused RMSNorm: a Triton kernel for Hopper and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_kernel``), whose function the JAX model computes through the jnp
twin ``repro.models.layers.rmsnorm`` on every block (``ln1``, ``ln2``),
on qk-norm and on the final norm.  The port sends all of those through
this kernel: 113 launches per qwen3-0.6b decode step.

What bounds it on the H100: bytes — one read of x, one write of y, and
the (d,) scale, with ~4 flops per element.  Design: one Triton program
per row with ``BLOCK = next_pow2(d)``, so a row (d = 1024 for the
residual norms, d = 128 for qk-norm) is one masked load, an f32
mean-square reduction in registers, and one store — the one-pass row
reduction fused with the scale that Triton is allowed for.  Known gap:
at d = 128 a program moves only 512 bytes, so the qk-norm launches are
bound by launch latency, not bytes; fusing them into the projection
epilogue is later work.

Triton is imported inside the launching function (hosts without a card
have no ``triton``).  :func:`rmsnorm` only ever launches the kernel and
raises for a CPU tensor; the device dispatch lives in
:func:`repro_torch.kernels.ops.rmsnorm`, and the plain version is
:func:`rmsnorm_ref`.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]

# triton.language, bound by _jit() at first launch: the kernel body below
# is plain source until then (no triton on hosts without a card)
tl = None
_jitted = None


def _rmsnorm_rows(x_ptr, scale_ptr, y_ptr, n_cols, eps,
                  BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    base = row.to(tl.int64) * n_cols
    x = tl.load(x_ptr + base + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    y = x * tl.rsqrt(var + eps)
    s = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + base + cols, (y * s).to(y_ptr.dtype.element_ty),
             mask=mask)


def _jit():
    """Import triton and JIT-wrap the kernel body (first launch only)."""
    global tl, _jitted
    if _jitted is None:
        os.environ.setdefault("TRITON_CACHE_DIR", build.triton_cache_dir())
        import triton
        import triton.language

        tl = triton.language
        _jitted = triton.jit(_rmsnorm_rows)
    return _jitted


_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Launch the Triton kernel: RMSNorm over the last axis of x.

    x: (..., d) float32 or bfloat16, contiguous, on a CUDA device; scale:
    (d,) float32 or bfloat16 on the same device.  f32 statistics, output
    in x's dtype.  Counts each launch in ``rmsnorm.launches``; an x with
    no rows launches nothing and counts nothing.
    """
    if not x.is_cuda or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel: x and scale must lie on one "
                         f"CUDA device, got {x.device} and {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.dim() != 1 or scale.shape[0] != d:
        raise ValueError(f"rmsnorm kernel: scale must be ({d},), got "
                         f"{tuple(scale.shape)}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel: x and scale must be contiguous")
    kernel = _jit()
    y = torch.empty_like(x)
    rows = x.numel() // d
    block = 1 << max(d - 1, 1).bit_length()
    if rows:
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, scale, y, d, eps, BLOCK=block,
                            num_warps=4 if block >= 1024 else 1)
        rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
