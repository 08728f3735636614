"""Fused RMSNorm, forward and backward: Triton kernels for Hopper and their
wrappers.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_kernel``), whose function the JAX model computes through the jnp
twin ``repro.models.layers.rmsnorm`` on every block (``ln1``, ``ln2``),
on qk-norm and on the final norm.  The port sends all of those through
this kernel: 113 launches per qwen3-0.6b decode step, and per train step
225 forward (113, plus 112 recomputed under block remat) and 113
backward launches.

What bounds it on the H100: bytes — one read of x, one write of y, and
the (d,) scale, with ~4 flops per element.  Design: one Triton program
per row with ``BLOCK = next_pow2(d)``, so a row (d = 1024 for the
residual norms, d = 128 for qk-norm) is one masked load, an f32
mean-square reduction in registers, and one store — the one-pass row
reduction fused with the scale that Triton is allowed for.  Known gap:
at d = 128 a program moves only 512 bytes, so the qk-norm launches are
bound by launch latency, not bytes; fusing them into the projection
epilogue is later work.

Backward (the JAX model differentiates the jnp twin; the Pallas kernel
has none): with ``r = rsqrt(mean(x**2) + eps)`` per row,
``dx = r*s*dy - x*r**3*mean(x*s*dy)`` and ``dscale = sum_rows dy*x*r``,
all in f32.  Bound: bytes — x and dy read once, dx written once.  Design:
a grid of at most :data:`BWD_PROGRAMS` programs, each sweeping tiles of
``BLOCK_R`` rows (``BLOCK_R * BLOCK_D`` = 4096 values, so a d = 128 row
is not a lone 512-byte program) and keeping its partial ``dscale`` row
in registers; the partial rows, written once per program, are summed by
one ``torch.sum``.

Triton is imported inside the launching function (hosts without a card
have no ``triton``).  :func:`rmsnorm` and :func:`rmsnorm_bwd` only ever
launch their kernels and raise for a CPU tensor; the autograd wiring and
the device dispatch live in :func:`repro_torch.kernels.ops.rmsnorm`, and
the plain versions are :func:`rmsnorm_ref` and :func:`rmsnorm_bwd_ref`.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_ref", "rmsnorm_bwd_ref"]

# triton.language, bound by _jit() at first launch: the kernel bodies below
# are plain source until then (no triton on hosts without a card)
tl = None
_jitted = None
# most programs of one backward launch (4 per SM of an H100): each writes
# one partial dscale row
BWD_PROGRAMS = 528


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


def _rmsnorm_bwd_rows(x_ptr, scale_ptr, dy_ptr, dx_ptr, dscale_ptr, n_rows,
                      n_cols, eps, BLOCK_R: tl.constexpr,
                      BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    n_prog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < n_cols
    s = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    dscale = tl.zeros([BLOCK_D], dtype=tl.float32)
    for rb in range(pid, tl.cdiv(n_rows, BLOCK_R), n_prog):
        rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=1) / n_cols + eps)
        sdy = s[None, :] * dy
        c = tl.sum(x * sdy, axis=1) / n_cols
        dx = r[:, None] * sdy - x * (r * r * r * c)[:, None]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        dscale += tl.sum(dy * x * r[:, None], axis=0)
    tl.store(dscale_ptr + pid * n_cols + cols, dscale, mask=cmask)


def _jit():
    """Import triton and JIT-wrap the kernel bodies (first launch only);
    returns (forward, backward)."""
    global tl, _jitted
    if _jitted is None:
        os.environ.setdefault("TRITON_CACHE_DIR", build.triton_cache_dir())
        import triton
        import triton.language

        tl = triton.language
        _jitted = (triton.jit(_rmsnorm_rows), triton.jit(_rmsnorm_bwd_rows))
    return _jitted


_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, scale: torch.Tensor, dy=None) -> None:
    tensors = [t for t in (x, scale, dy) if t is not None]
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError(f"rmsnorm kernel: x, scale and dy must lie on one "
                         f"CUDA device, got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.dim() != 1 or scale.shape[0] != d:
        raise ValueError(f"rmsnorm kernel: scale must be ({d},), got "
                         f"{tuple(scale.shape)}")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"rmsnorm kernel: dy must match x "
                         f"({tuple(x.shape)}, {x.dtype}), got "
                         f"({tuple(dy.shape)}, {dy.dtype})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rmsnorm kernel: x, scale and dy must be "
                         "contiguous")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Launch the Triton kernel: RMSNorm over the last axis of x.

    x: (..., d) float32 or bfloat16, contiguous, on a CUDA device; scale:
    (d,) float32 or bfloat16 on the same device.  f32 statistics, output
    in x's dtype.  Counts each launch in ``rmsnorm.launches``; an x with
    no rows launches nothing and counts nothing.
    """
    _check(x, scale)
    kernel = _jit()[0]
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    block = 1 << max(d - 1, 1).bit_length()
    if rows:
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, scale, y, d, eps, BLOCK=block,
                            num_warps=4 if block >= 1024 else 1)
        rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """Launch the Triton backward kernel: gradients of :func:`rmsnorm`.

    x and dy: (..., d) float32 or bfloat16 alike, contiguous, on one CUDA
    device; scale: (d,).  Returns (dx in x's dtype, dscale in scale's
    dtype), as :func:`rmsnorm_bwd_ref` does.  Counts each launch in
    ``rmsnorm_bwd.launches``; an x with no rows launches nothing.
    """
    _check(x, scale, dy)
    kernel = _jit()[1]
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(scale)
    block_d = 1 << max(d - 1, 1).bit_length()
    block_r = max(1, 4096 // block_d)
    n_prog = min(BWD_PROGRAMS, -(-rows // block_r))
    partial = torch.empty((n_prog, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernel[(n_prog,)](x, scale, dy, dx, partial, rows, d, eps,
                          BLOCK_R=block_r, BLOCK_D=block_d, num_warps=4)
    rmsnorm_bwd.launches += 1
    return dx, partial.sum(dim=0).to(scale.dtype)


rmsnorm_bwd.launches = 0
