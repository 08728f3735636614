"""sLSTM recurrence: the CUDA C++ kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/slstm.py`` (``slstm_scan``,
body ``_kernel``).  The kernel itself is ``csrc/slstm.cu`` (its source
note says what bounds it — at the function level bytes, in practice the
per-step re-read of ``r_h`` from L2 — and what its design does about
that); it is compiled by ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`) and called through ``ctypes``.  Its
plain PyTorch version, which the CPU path runs and ``chip_smoke.py`` holds
the kernel against, is :func:`slstm_ref`.

Unlike the TPU kernel, which keeps the state in VMEM scratch, both return
the final ``(h, c, n, m)`` beside the outputs: the serving prefill writes
it into the request's slot row.  :func:`slstm_scan` only ever launches the
kernel: it raises for a tensor that is not on a CUDA device, and for any
dtype, shape or layout the kernel does not take.  The device dispatch
lives in :func:`repro_torch.kernels.ops.slstm_scan`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import slstm_ref

__all__ = ["slstm_scan", "slstm_ref"]

# most channels per head: one thread each in a block
MAX_HEAD_DIM = 1024


def _check(gx: torch.Tensor, r_h: torch.Tensor) -> None:
    for name, t in (("gx", gx), ("r_h", r_h)):
        if not t.is_cuda or t.device != gx.device:
            raise ValueError(f"slstm_scan kernel: {name} must lie on gx's "
                             f"CUDA device {gx.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"slstm_scan kernel: {name} must be "
                             "contiguous")
    if gx.dim() != 3 or r_h.dim() != 3 or gx.shape[2] % 4:
        raise ValueError(f"slstm_scan kernel: gx must be (B, S, 4d) and "
                         f"r_h (H, dh, 4dh); got {tuple(gx.shape)}, "
                         f"{tuple(r_h.shape)}")
    B, S, d4 = gx.shape
    H, dh = r_h.shape[:2]
    if H * dh != d4 // 4 or tuple(r_h.shape) != (H, dh, 4 * dh):
        raise ValueError(f"slstm_scan kernel: r_h must be (H, d/H, 4d/H) "
                         f"for d = {d4 // 4}; got {tuple(r_h.shape)}")
    if dh > MAX_HEAD_DIM or S < 1 or B < 1:
        raise ValueError(f"slstm_scan kernel: head dim {dh} must be at "
                         f"most {MAX_HEAD_DIM}, B and S at least 1")


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor):
    """Launch the CUDA kernel: the sLSTM recurrence of :func:`slstm_ref`.

    gx: (B, S, 4d) gate pre-activations ``[i|f|z|o]``; r_h: (H, dh, 4dh),
    dh = d / H at most :data:`MAX_HEAD_DIM`; both float32, contiguous, on
    one CUDA device.  Returns ``h`` (B, S, d) and the final ``(h, c, n,
    m)``, (B, d) each, float32.  Counts each launch in
    ``slstm_scan.launches``.
    """
    _check(gx, r_h)
    B, S, d4 = gx.shape
    d, H = d4 // 4, r_h.shape[0]
    lib = build.load_library()
    out = torch.empty((B, S, d), dtype=torch.float32, device=gx.device)
    state = tuple(torch.empty((B, d), dtype=torch.float32, device=gx.device)
                  for _ in range(4))
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.repro_slstm_scan(
            gx.data_ptr(), r_h.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in state), B, S, d, H, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    slstm_scan.launches += 1
    return out, state


slstm_scan.launches = 0
