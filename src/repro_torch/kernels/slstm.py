"""sLSTM recurrence: the CUDA C++ kernels' wrappers, forward and backward.

Replaces the Pallas TPU kernel ``repro/kernels/slstm.py`` (``slstm_scan``,
body ``_kernel``).  The kernel itself is ``csrc/slstm.cu`` (its source
note says what bounds it — the S sequential steps, each one cluster-wide
exchange of ``h`` — and what its design does about that); it is compiled
by ``nvcc`` for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`)
and called through ``ctypes``.  Its plain PyTorch version, which the CPU
path runs and ``chip_smoke.py`` holds the kernel against, is
:func:`slstm_ref`.

The kernel runs each (row, head) on a cluster of C blocks, each holding
the ``r_h`` columns of its share of the head's channels in registers;
:func:`cluster_plan` picks C.  Unlike the TPU kernel, which keeps the
state in VMEM scratch, both return the final ``(h, c, n, m)`` beside the
outputs: the serving prefill writes it into the request's slot row.

Called for training, the forward also writes every step's gate
pre-activations and state ``(c, n, m)``, which :func:`slstm_scan_bwd`
(``repro_slstm_scan_bwd`` in the same source, on the same cluster plan;
no TPU kernel is its counterpart, the JAX model differentiates its
``lax.scan`` twin ``xlstm.slstm_block``) reads on its reverse sweep; its
plain version is :func:`slstm_bwd_ref`.  Both wrappers only ever launch
their kernels: they raise for a tensor that is not on a CUDA device, and
for any dtype, shape or layout the kernels do not take.  The device
dispatch lives in :func:`repro_torch.kernels.ops.slstm_scan`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import slstm_bwd_ref, slstm_r_h_grad, slstm_ref

__all__ = ["slstm_scan", "slstm_scan_bwd", "slstm_ref", "slstm_bwd_ref",
           "cluster_plan", "bwd_plan", "residuals"]

# cluster sizes the kernel launches with (16 is past the portable 8 and
# needs the non-portable attribute, which the kernel sets)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# bytes of r_h one block holds in its registers: a head's dh x 4*cb f32
# columns (74 KB at dh = 192, C = 8), at most 80 weights a thread, well
# inside an SM's 256 KB register file
SLICE_BYTES = 96 * 1024


def slice_bytes(dh: int, cb: int) -> int:
    """Bytes of one block's ``r_h`` slice: dh rows of 4 gates x cb f32."""
    return 4 * dh * 4 * cb


def cluster_plan(dh: int) -> tuple:
    """``(C, cb)`` for a head of ``dh`` channels: the smallest cluster in
    :data:`CLUSTER_SIZES` whose blocks, cb = ceil(dh / C) channels each
    (block c owns ``[c * cb, min((c + 1) * cb, dh))``, which may be empty
    at the tail), hold at most :data:`SLICE_BYTES` of ``r_h``.  Raises
    past :data:`MAX_HEAD_DIM`."""
    for C in CLUSTER_SIZES:
        cb = -(-dh // C)
        if slice_bytes(dh, cb) <= SLICE_BYTES:
            return C, cb
    raise ValueError(f"slstm_scan kernel: head dim {dh} must be at most "
                     f"{MAX_HEAD_DIM} (a 16-block cluster's r_h slices)")


def _max_head_dim() -> int:
    C = CLUSTER_SIZES[-1]
    dh = 1
    while slice_bytes(dh + 1, -(-(dh + 1) // C)) <= SLICE_BYTES:
        dh += 1
    return dh


# the widest head a 16-block cluster holds (307 channels)
MAX_HEAD_DIM = _max_head_dim()

# the backward's lanes per r_h row (``ks`` in the source: the fewest whose
# slices hold at most BWD_KMAX weights), its threads a block at most and
# the most weights a lane holds (``BWD_THREADS``, ``BWD_KMAX``)
BWD_SLICES = (4, 8, 16)
BWD_THREADS = 448
BWD_KMAX = 96


def bwd_plan(dh: int) -> tuple:
    """``(C, cb, ks, kl)`` of the backward kernel for a head of ``dh``
    channels: the forward's :func:`cluster_plan`, and row ``r < cb`` of
    block ``c`` (head channel ``c * cb + r``) run by ``ks`` adjacent lanes
    of one warp (thread ``r * ks + s`` runs slice ``s``; ``ks`` the fewest
    of :data:`BWD_SLICES` that keeps a slice within :data:`BWD_KMAX`
    weights: 8 at xlstm-125m's dh = 192, 192 threads a block, two blocks
    an SM).  Slice ``s`` holds ``kl = 4 * ceil(dh / ks)`` weights of its
    row: for ``m < kl / 4`` and gate ``g``, the column ``g * dh + m * ks
    + s`` (zero past dh), and reads the gate cotangents of the same
    channels, kept channel-major (``BwdLayout`` in ``csrc/slstm.cu``).
    Raises past :data:`MAX_HEAD_DIM`, as :func:`cluster_plan` does,
    before any launch."""
    C, cb = cluster_plan(dh)
    ks = next((k for k in BWD_SLICES if 4 * -(-dh // k) <= BWD_KMAX),
              BWD_SLICES[-1])
    kl = 4 * -(-dh // ks)
    if -(-ks * cb // 32) * 32 > BWD_THREADS or kl > BWD_KMAX or C > ks:
        raise ValueError(f"slstm_scan_bwd kernel: {ks} slices of {kl} "
                         f"weights for {cb} rows of a {C}-block cluster "
                         f"exceed {BWD_THREADS} threads, {BWD_KMAX} "
                         f"weights a lane or one sending lane a block")
    return C, cb, ks, kl


def residuals(gx: torch.Tensor) -> tuple:
    """Empty buffers for what the forward saves for training, for gx (B,
    S, 4d): the gate pre-activations (B, S, 4d) and the state ``(c, n,
    m)`` after every step, (B, S, d) each."""
    B, S, d4 = gx.shape
    return (torch.empty_like(gx),) + tuple(
        torch.empty((B, S, d4 // 4), dtype=torch.float32, device=gx.device)
        for _ in range(3))


def _check_like(name: str, tensors, shape, device) -> None:
    for t in tensors:
        if tuple(t.shape) != tuple(shape) or t.device != device \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"slstm_scan kernel: {name} must be contiguous "
                             f"float32 {tuple(shape)} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check(gx: torch.Tensor, r_h: torch.Tensor) -> None:
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


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor, saved=None):
    """Launch the CUDA kernel: the sLSTM recurrence of :func:`slstm_ref`.

    gx: (B, S, 4d) gate pre-activations ``[i|f|z|o]``; r_h: (H, dh, 4dh),
    dh = d / H at most :data:`MAX_HEAD_DIM`; both float32, contiguous, on
    one CUDA device.  ``saved`` (training only): the :func:`residuals`
    buffers, which the kernel fills for :func:`slstm_scan_bwd`.  Returns
    ``h`` (B, S, d) and the final ``(h, c, n, m)``, (B, d) each, float32.
    Counts each launch in ``slstm_scan.launches``.
    """
    _check(gx, r_h)
    if saved is not None:
        _check_like("the gates buffer", saved[:1], gx.shape, gx.device)
        _check_like("a state buffer", saved[1:], gx.shape[:2]
                    + (gx.shape[2] // 4,), gx.device)
    B, S, d4 = gx.shape
    d, H = d4 // 4, r_h.shape[0]
    C, cb = cluster_plan(d // H)
    lib = build.load_library()
    out = torch.empty((B, S, d), dtype=torch.float32, device=gx.device)
    state = tuple(torch.empty((B, d), dtype=torch.float32, device=gx.device)
                  for _ in range(4))
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = lib.repro_slstm_scan(
            gx.data_ptr(), r_h.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in state),
            *((None,) * 4 if saved is None else (t.data_ptr() for t in saved)),
            B, S, d, H, C, cb, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    build.count_launch(slstm_scan)
    return out, state


slstm_scan.launches = 0


def slstm_scan_bwd(r_h: torch.Tensor, h: torch.Tensor, saved, dh: torch.Tensor,
                   d_final):
    """Launch the backward kernel: the gradients of :func:`slstm_bwd_ref`.

    r_h: (H, dh, 4dh); h: the forward's outputs (B, S, d); saved: the
    :func:`residuals` the forward filled; dh: the cotangent of ``h`` (B,
    S, d); d_final: those of the final ``(h, c, n, m)``, (B, d) each; all
    float32, contiguous, on one CUDA device.  The kernel writes ``d_gx``
    (B, S, 4d); ``d_r_h`` is then one batched product over all steps
    (:func:`slstm_r_h_grad`), outside the recurrence.  Returns ``(d_gx,
    d_r_h)``.  Counts each launch in ``slstm_scan_bwd.launches``.
    """
    pre = saved[0]
    _check(pre, r_h)
    B, S, d4 = pre.shape
    d, H = d4 // 4, r_h.shape[0]
    _check_like("a state buffer", (*saved[1:], h, dh), (B, S, d), pre.device)
    _check_like("a final-state cotangent", d_final, (B, d), pre.device)
    C, cb, _, _ = bwd_plan(d // H)
    lib = build.load_library()
    d_gx = torch.empty_like(pre)
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        err = lib.repro_slstm_scan_bwd(
            *(t.data_ptr() for t in (*saved, r_h, dh, *d_final, d_gx)),
            B, S, d, H, C, cb, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(slstm_scan_bwd)
    return d_gx, slstm_r_h_grad(h, d_gx, H)


slstm_scan_bwd.launches = 0
