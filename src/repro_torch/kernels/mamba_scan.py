"""Selective scan (Mamba): the CUDA C++ kernel's wrapper.

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
into the request's slot row.  :func:`mamba_scan` only ever launches the
kernel: it raises for a tensor that is not on a CUDA device, and for any
dtype, shape or layout the kernel does not take.  The device dispatch
lives in :func:`repro_torch.kernels.ops.mamba_scan`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref", "scan_plan"]

# state sizes the kernel is compiled for (a template parameter)
STATE_SIZES = (8, 16)
# threads of one block (``THREADS`` in the source), adjacent channels a
# thread (``K``), and the lanes a channel's states are split over (the one
# split compiled: the fastest of 2, 4 and 8 at N = 8 and 16 on an H100,
# PERF.md)
THREADS = 128
CHANNELS_PER_THREAD = 2
LANES = 4


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


def _check(dt, xc, bm, cm, a) -> None:
    for name, t in (("dt", dt), ("xc", xc), ("bm", bm), ("cm", cm),
                    ("a", a)):
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


def mamba_scan(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor):
    """Launch the CUDA kernel: the selective scan of :func:`mamba_scan_ref`.

    dt/xc: (B, S, d); bm/cm: (B, S, N), N in :data:`STATE_SIZES`; a: (d,
    N); all float32, contiguous, on one CUDA device.  Returns ``y`` (B, S,
    d) and the final state (B, d, N), float32.  Counts each launch in
    ``mamba_scan.launches``.
    """
    _check(dt, xc, bm, cm, a)
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
            a.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, d, N, L,
            stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(mamba_scan)
    return y, h_last


mamba_scan.launches = 0
