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
normalises a tile of ``BLOCK_R`` rows x ``BLOCK_D = next_pow2(d)``
columns — 16-byte loads, an f32 mean-square per row in registers, one
store: the one-pass row reduction fused with the scale that Triton is
allowed for.  :func:`plan` takes the tile from a fixed table keyed by
BLOCK_D (64 rows of 128, 8 rows of 1024, one row of 8192 on 8 warps), so
a program moves kilobytes.  The first design ran one program per row: at
the train step's q-norm rows (262144 x 128) a program moved 512 bytes and
the block scheduler, not HBM, set the pace, 0.1630 ms against a 0.0401
ms bound; 64-row tiles take 0.0502 ms (80% of it; 131072 x 128: 0.0285
ms, 70%; ``chip_smoke.py`` on an H100 80GB HBM3 at 700 W).  A few decode
rows (8 x 1024) still take one row a program (so does any launch with
fewer than :data:`SMS` tiles): ~6 us, the launch's latency, which only
fusing them or a CUDA graph would remove.

Backward (the JAX model differentiates the jnp twin; the Pallas kernel
has none): with ``r = rsqrt(mean(x**2) + eps)`` per row,
``dx = r*s*dy - x*r**3*mean(x*s*dy)`` and ``dscale = sum_rows dy*x*r``,
all in f32.  Bound: bytes — x and dy read once, dx written once.  Design:
a grid of at most :data:`BWD_PROGRAMS` programs, each sweeping row tiles
from the same table (2 rows of 1024, 32 of 128) with the next tiles'
loads in flight (``tl.range`` stages), and keeping its partial ``dscale``
row in registers.  A second launch sums the partial rows of each column
in a fixed order and casts: ``dscale`` is bit-reproducible (no float
atomics), in one launch where ``torch.sum`` and the cast took two slower
ones.  16384 x 1024 takes 0.0461 ms against a 0.0300 ms bound (the first
design: 0.0624).

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


def _rmsnorm_rows(x_ptr, scale_ptr, y_ptr, n_rows, n_cols, eps,
                  BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < n_cols
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    s = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    r = tl.rsqrt(tl.sum(x * x, axis=1) / n_cols + eps)
    y = x * r[:, None] * s[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


def _rmsnorm_bwd_rows(x_ptr, scale_ptr, dy_ptr, dx_ptr, partial_ptr, n_rows,
                      n_cols, eps, BLOCK_R: tl.constexpr,
                      BLOCK_D: tl.constexpr, STAGES: tl.constexpr):
    pid = tl.program_id(0)
    n_prog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < n_cols
    s = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    dscale = tl.zeros([BLOCK_D], dtype=tl.float32)
    for rb in tl.range(pid, tl.cdiv(n_rows, BLOCK_R), n_prog,
                       num_stages=STAGES):
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
    tl.store(partial_ptr + pid * n_cols + cols, dscale, mask=cmask)


def _dscale_cols(partial_ptr, dscale_ptr, n_part, n_cols,
                 BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    # dscale[cols] = the partial rows summed in a fixed order (no atomics),
    # cast to scale's dtype
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, n_part, BLOCK_P):
        parts = p0 + tl.arange(0, BLOCK_P)
        mask = (parts < n_part)[:, None] & cmask[None, :]
        acc += tl.sum(tl.load(partial_ptr + parts[:, None] * n_cols
                              + cols[None, :], mask=mask, other=0.0), axis=0)
    tl.store(dscale_ptr + cols, acc.to(dscale_ptr.dtype.element_ty),
             mask=cmask)


def _jit():
    """Import triton and JIT-wrap the kernel bodies (first launch only);
    returns (forward, backward, dscale column sum)."""
    global tl, _jitted
    if _jitted is None:
        os.environ.setdefault("TRITON_CACHE_DIR", build.triton_cache_dir())
        import triton
        import triton.language

        tl = triton.language
        _jitted = tuple(triton.jit(f) for f in (
            _rmsnorm_rows, _rmsnorm_bwd_rows, _dscale_cols))
    return _jitted


# row tiles of the two kernels, keyed by BLOCK_D = next_pow2(d), rows up to
# 128 wide sharing the 128 entry: (forward rows, forward warps, backward
# rows, backward warps, backward stages).  A forward tile holds 8192 values
# of x, a backward one 4096 up to d = 256 and 2048 from d = 512 (it also
# holds dy); rows of 4096 and more take one row a tile.  The backward's
# stages are the tiles its loop keeps in flight (its loads run ahead of
# the tile it computes).
TILES = {128: (64, 4, 32, 4, 2), 256: (32, 4, 16, 4, 2),
         512: (16, 4, 4, 4, 3), 1024: (8, 4, 2, 4, 3), 2048: (4, 8, 1, 4, 3),
         4096: (1, 8, 1, 4, 3), 8192: (1, 8, 1, 8, 3),
         16384: (1, 16, 1, 16, 3), 32768: (1, 16, 1, 16, 3),
         65536: (1, 32, 1, 32, 3)}
# most values of x in one tile, unless the tile is one row
TILE_VALUES = 8192
# SMs of an H100: a launch whose tiles would number fewer takes one row a
# program, so a few decode rows still spread out (on at least 256 values a
# warp: 8 a thread, one 16-byte load of bf16).  Two tiles a width, not a
# tile per row count: Triton compiles each tile at the first call that
# meets it, and again for each class of row count it specialises on (1, a
# multiple of 16, any other; knowing a multiple of 16 makes the 1024-wide
# forward faster on an H100, PERF.md, so the kernels keep it).
SMS = 132
# widest row the kernels take
MAX_D = max(TILES)


def plan(rows: int, d: int, backward: bool = False) -> tuple:
    """``(BLOCK_R, BLOCK_D, num_warps, grid)`` of one launch over ``rows``
    rows of ``d``: BLOCK_D = next_pow2(d); BLOCK_R rows a tile from
    :data:`TILES`, or one row (with the warps cut to it) where the tiles
    would number fewer than :data:`SMS`.  The forward
    grid has one program per tile; the backward at most
    :data:`BWD_PROGRAMS`, program ``p`` sweeping tiles ``p, p + grid,
    ...``.  Tile ``t`` holds rows ``[t * BLOCK_R, (t + 1) * BLOCK_R)``,
    masked past ``rows``.  Raises for ``rows < 1`` or a d past
    :data:`MAX_D`."""
    if rows < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel: rows={rows} must be at least 1 "
                         f"and d={d} between 1 and {MAX_D}")
    block_d = 1 << (d - 1).bit_length()
    fwd_r, fwd_w, bwd_r, bwd_w, _ = TILES[max(block_d, 128)]
    block_r, warps = (bwd_r, bwd_w) if backward else (fwd_r, fwd_w)
    if -(-rows // block_r) < SMS:
        block_r = 1
        warps = max(1, min(warps, block_d // 256))
    tiles = -(-rows // block_r)
    grid = min(tiles, BWD_PROGRAMS) if backward else tiles
    return block_r, block_d, warps, grid


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
    if rows:
        block_r, block_d, warps, grid = plan(rows, d)
        with torch.cuda.device(x.device):
            kernel[(grid,)](x, scale, y, rows, d, eps, BLOCK_R=block_r,
                            BLOCK_D=block_d, num_warps=warps)
        build.count_launch(rmsnorm)
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
    _, kernel, total = _jit()
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(scale)
    block_r, block_d, warps, n_prog = plan(rows, d, backward=True)
    partial = torch.empty((n_prog, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    block_p = min(1024, 1 << (n_prog - 1).bit_length())
    block_c = min(block_d, max(1, TILE_VALUES // block_p))
    with torch.cuda.device(x.device):
        kernel[(n_prog,)](x, scale, dy, dx, partial, rows, d, eps,
                          BLOCK_R=block_r, BLOCK_D=block_d,
                          STAGES=TILES[max(block_d, 128)][4],
                          num_warps=warps)
        total[(-(-d // block_c),)](partial, dscale, n_prog, d,
                                   BLOCK_P=block_p, BLOCK_C=block_c,
                                   num_warps=4)
    build.count_launch(rmsnorm_bwd)
    return dx, dscale


rmsnorm_bwd.launches = 0
