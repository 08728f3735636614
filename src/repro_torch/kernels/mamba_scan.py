"""Selective scan (Mamba): the CUDA C++ kernels' wrappers, forward and
backward.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_scan``, body ``_kernel``).  The kernel itself is
``csrc/mamba_scan.cu`` (its source note says what bounds it — the
exponentials at the special-function units' rate, then bytes — and what
its design does about that); it is compiled by ``nvcc`` for ``sm_90a`` at
first use (:mod:`repro_torch.kernels.build`) and called through
``ctypes``.  The kernel splits a channel's N states over L adjacent lanes
of a warp; :func:`scan_plan` gives L and with it the block's channels.
Its plain PyTorch version, which the CPU path runs and ``chip_smoke.py``
holds the kernel against, is :func:`mamba_scan_ref`.

Unlike the TPU kernel, which keeps the state in VMEM scratch, both return
the state after the last step beside ``y``: the serving prefill writes it
into the request's slot row.  Called for training, the forward also fills
a buffer with the state before every tile of :data:`TILE` steps, from
which :func:`mamba_scan_bwd` (``repro_mamba_scan_bwd`` in the same
source; no TPU kernel is its counterpart, the JAX model differentiates
its ``lax.scan`` twin ``ssm._mamba_core``) recomputes each tile's states
on its reverse sweep, a sub-tile of :data:`SUB` steps at a time into
registers (:func:`bwd_sweep`); its plain version is
:func:`mamba_scan_bwd_ref`.
Both wrappers only ever launch their kernels: they raise for a tensor
that is not on a CUDA device, and for any dtype, shape or layout the
kernels do not take.  The device dispatch lives in
:func:`repro_torch.kernels.ops.mamba_scan`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_bwd_ref, mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_bwd", "mamba_scan_ref",
           "mamba_scan_bwd_ref", "scan_plan", "ckpt_shape", "bwd_sweep",
           "bwd_sum_lane", "bwd_occupancy"]

# state sizes the kernel is compiled for (a template parameter)
STATE_SIZES = (8, 16)
# threads of one block (``THREADS`` in the source), adjacent channels a
# thread (``K``), and the lanes a channel's states are split over (the one
# split compiled: the fastest of 2, 4 and 8 at N = 8 and 16 on an H100,
# PERF.md)
THREADS = 128
CHANNELS_PER_THREAD = 2
LANES = 4
# steps per staged tile (``T`` in the source): the forward checkpoints the
# state before every tile for the backward
TILE = 32
# steps of a backward sub-tile (``SUB`` in the source), whose states are
# recomputed into registers from the tile's checkpoint and swept
SUB = 8


def scan_plan(d: int, N: int) -> tuple:
    """``(L, CH)`` for d channels of N states.  Thread ``x`` of a block
    runs channels ``x // L * K + q`` (q < K = :data:`CHANNELS_PER_THREAD`)
    of the block, states ``[(x % L) * N/L, (x % L + 1) * N/L)`` of each:
    L adjacent lanes share a channel.  A block of :data:`THREADS` threads
    owns CH = THREADS / L * K consecutive channels (block ``i`` owns
    ``[i * CH, (i+1) * CH)``, masked past d).  Raises for an N the kernel
    is not compiled for."""
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel: N={N} must be one of "
                         f"{STATE_SIZES}")
    if d < 1:
        raise ValueError(f"mamba_scan kernel: d={d} must be at least 1")
    return LANES, THREADS // LANES * CHANNELS_PER_THREAD


def ckpt_shape(dt: torch.Tensor, a: torch.Tensor) -> tuple:
    """Shape of the forward's tile checkpoints for dt (B, S, d) and a (d,
    N): (B, ceil(S / TILE), d, N)."""
    B, S, d = dt.shape
    return (B, -(-S // TILE), d, a.shape[1])


def bwd_sweep(S: int) -> list:
    """The backward kernel's walk over S steps: ``(tile, sub_tile,
    steps)`` for each sub-tile in the order it is swept, tiles of
    :data:`TILE` steps last first and a tile's sub-tiles of :data:`SUB`
    steps last first; ``steps`` are the sub-tile's steps below S in the
    order swept.  Sub-tile 0 of a tile starts from the tile's checkpoint,
    sub-tile ``u > 0`` from the state a first pass over the tile's
    earlier steps left in shared memory."""
    order = []
    for k in reversed(range(-(-S // TILE))):
        t0 = k * TILE
        for u in reversed(range(-(-min(TILE, S - t0) // SUB))):
            lo = t0 + u * SUB
            order.append((k, u, list(range(min(lo + SUB, S) - 1, lo - 1,
                                           -1))))
    return order


def bwd_sum_lane(lane: int, N: int):
    """The per-step sum of d_B or d_C that lane ``lane`` of a warp stores
    after the backward's reduce-scatter over the warp's 8 channel groups
    (``sum_groups`` in the source): ``("b" | "c", state)``, or None where
    another lane stores the same sum (N = 8: the lanes with bit 2 set).
    The lane holds 2 N/L partial sums (d_B, then d_C, of the states
    ``[j * N/L, (j+1) * N/L)``, j = lane % L) and ends with the one that
    its lane bits 4, 3 (and 2, at 8 values) pick."""
    L, _ = scan_plan(1, N)
    nl = N // L
    if 2 * nl == 8:
        v = lane >> 2
    elif lane & 4:
        return None
    else:
        v = lane >> 3
    return ("b" if v < nl else "c", (lane % L) * nl + v % nl)


def bwd_occupancy(N: int) -> tuple:
    """``(blocks, smem)``: the backward sweep's blocks an SM on the current
    CUDA device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and its
    shared memory a block in bytes, for N in :data:`STATE_SIZES`.  Needs
    the card; launches nothing."""
    scan_plan(1, N)
    lib = build.load_library()
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = lib.repro_mamba_scan_bwd_occupancy(N, ctypes.byref(blocks),
                                             ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd occupancy query failed: CUDA "
                           f"error {err}")
    return blocks.value, smem.value


def _check(dt, xc, bm, cm, a, **more) -> None:
    for name, t in (("dt", dt), ("xc", xc), ("bm", bm), ("cm", cm),
                    ("a", a), *more.items()):
        if not t.is_cuda or t.device != dt.device:
            raise ValueError(f"mamba_scan kernel: {name} must lie on dt's "
                             f"CUDA device {dt.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan kernel: {name} must be "
                             "contiguous")
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba_scan kernel: dt must be (B, S, d) and a "
                         f"(d, N); got {tuple(dt.shape)}, {tuple(a.shape)}")
    B, S, d = dt.shape
    N = a.shape[1]
    if tuple(xc.shape) != (B, S, d) or tuple(a.shape) != (d, N) \
            or tuple(bm.shape) != (B, S, N) or tuple(cm.shape) != (B, S, N):
        raise ValueError(
            f"mamba_scan kernel: xc must be (B={B}, S={S}, d={d}), bm/cm "
            f"(B, S, N={N}), a (d, N); got {tuple(xc.shape)}, "
            f"{tuple(bm.shape)}, {tuple(cm.shape)}, {tuple(a.shape)}")
    if N not in STATE_SIZES or S < 1 or B < 1:
        raise ValueError(f"mamba_scan kernel: N={N} must be one of "
                         f"{STATE_SIZES}, B and S at least 1")
    want = {"h_ckpt": ckpt_shape(dt, a), "dy": (B, S, d),
            "dh_last": (B, d, N)}
    for name, t in more.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mamba_scan kernel: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")


def mamba_scan(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor, h_ckpt=None):
    """Launch the CUDA kernel: the selective scan of :func:`mamba_scan_ref`.

    dt/xc: (B, S, d); bm/cm: (B, S, N), N in :data:`STATE_SIZES`; a: (d,
    N); all float32, contiguous, on one CUDA device.  ``h_ckpt`` (training
    only) is a :func:`ckpt_shape` f32 buffer the kernel fills with the
    state before every tile.  Returns ``y`` (B, S, d) and the final state
    (B, d, N), float32.  Counts each launch in ``mamba_scan.launches``.
    """
    _check(dt, xc, bm, cm, a,
           **({} if h_ckpt is None else {"h_ckpt": h_ckpt}))
    B, S, d = dt.shape
    N = a.shape[1]
    L, _ = scan_plan(d, N)
    lib = build.load_library()
    y = torch.empty_like(dt)
    h_last = torch.empty((B, d, N), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.repro_mamba_scan(
            dt.data_ptr(), xc.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            None if h_ckpt is None else h_ckpt.data_ptr(), B, S, d, N, L,
            stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(mamba_scan)
    return y, h_last


mamba_scan.launches = 0


def mamba_scan_bwd(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, h_ckpt: torch.Tensor,
                   dy: torch.Tensor, dh_last: torch.Tensor):
    """Launch the backward kernel: the gradients of
    :func:`mamba_scan_bwd_ref`.

    The forward's inputs and its tile checkpoints ``h_ckpt``
    (:func:`ckpt_shape`), the cotangents ``dy`` (B, S, d) of ``y`` and
    ``dh_last`` (B, d, N) of the final state; all float32, contiguous, on
    one CUDA device.  Returns ``(d_dt, d_xc, d_bm, d_cm, d_a)``, each
    summed in a fixed order (two calls give equal bits).  Counts each
    launch in ``mamba_scan_bwd.launches``.
    """
    _check(dt, xc, bm, cm, a, h_ckpt=h_ckpt, dy=dy, dh_last=dh_last)
    B, S, d = dt.shape
    N = a.shape[1]
    L, CH = scan_plan(d, N)
    lib = build.load_library()
    out = [torch.empty_like(t) for t in (dt, xc, bm, cm, a)]
    f32 = dict(dtype=torch.float32, device=dt.device)
    # per channel block d_bm, d_cm, and per row d_a: summed after the sweep
    part_bc = torch.empty((2, -(-d // CH), B, S, N), **f32)
    part_a = torch.empty((B, d, N), **f32)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.repro_mamba_scan_bwd(
            *(t.data_ptr() for t in (dt, xc, bm, cm, a, h_ckpt, dy,
                                     dh_last)),
            *(t.data_ptr() for t in out), part_bc[0].data_ptr(),
            part_bc[1].data_ptr(), part_a.data_ptr(), B, S, d, N, L, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(mamba_scan_bwd)
    return tuple(out)


mamba_scan_bwd.launches = 0
