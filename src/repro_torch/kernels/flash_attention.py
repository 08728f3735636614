"""Flash attention, forward and backward: the CUDA C++ kernels' wrappers.

Replace the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``) and the backward the JAX model
writes by hand for its twin (``repro.models.layers._flash_vjp_bwd``).  The
kernels are ``csrc/flash_attention.cu`` (its source note says what bounds
them — operations — and what their design does about that); they are
compiled by ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels.build`) and called through ``ctypes``.  Their
plain PyTorch versions, which the CPU path runs and ``chip_smoke.py``
holds the kernels against, are :func:`flash_attention_fwd_ref` and
:func:`flash_attention_bwd_ref`.

Both wrappers only ever launch: they raise for a tensor that is not on a
CUDA device and for any dtype, shape or layout the kernels do not take.
The autograd wiring and the device dispatch live in
:func:`repro_torch.kernels.ops.flash_attention`.  The kernels sweep 64- or
128-key tiles where the plain versions sweep ``k_chunk``-key chunks, which
changes nothing but the f32 summation order.  The bf16 backward adds dq
into an f32 workspace with atomics, so its dq bits vary from call to call
(within tolerance); dk and dv do not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref)

__all__ = ["flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref"]

_DTYPES = (torch.float32, torch.bfloat16)
# head dims the kernels are compiled for (a template parameter)
HEAD_DIMS = (16, 64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, **others) -> None:
    for name, t in (("q", q), ("k", k), *others.items()):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} must lie on "
                             f"q's CUDA device {q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             "contiguous and 16-byte aligned")
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise TypeError(f"flash_attention kernel: {name} must be "
                            f"{want}, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention kernel: q must be (B, S, H, D) "
                         f"and k/v (B, S, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or H % Hkv or D not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel: k/v must be (B={B}, S={S}, Hkv, "
            f"D={D}) with H={H} a multiple of Hkv and D one of {HEAD_DIMS}; "
            f"got {tuple(k.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """Launch the forward kernel.

    q: (B, S, H, D); k/v: (B, S, Hkv, D); float32 or bfloat16, contiguous,
    on one CUDA device, D in :data:`HEAD_DIMS`.  Returns ``out`` (q's shape
    and dtype) and ``lse`` (B, S, H) float32, as
    :func:`flash_attention_fwd_ref` does.  Counts each launch in
    ``flash_attention_fwd.launches``.
    """
    _check(q, k, v=v)
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention kernel: v {tuple(v.shape)} must "
                         f"match k {tuple(k.shape)}")
    B, S, H, D = q.shape
    lib = build.load_library()
    out = torch.empty_like(q)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], D, int(causal),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention forward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True):
    """Launch the backward kernels.

    bf16: a pre-pass (delta, lse rows), one pass for dq/dk/dv, a dq cast;
    f32: the delta pre-pass, dK/dV, then dQ.

    The residuals of :func:`flash_attention_fwd` (q, k, v, out, lse) and the
    output cotangent ``dout`` (out's shape and dtype).  Returns (dq, dk,
    dv) in the inputs' dtype, as :func:`flash_attention_bwd_ref` does.
    Counts one launch per call in ``flash_attention_bwd.launches``.
    """
    _check(q, k, v=v, out=out, dout=dout, lse=lse)
    B, S, H, D = q.shape
    if tuple(v.shape) != tuple(k.shape) or out.shape != q.shape \
            or dout.shape != q.shape or tuple(lse.shape) != (B, S, H):
        raise ValueError("flash_attention kernel: v must match k, out and "
                         "dout must match q, lse must be (B, S, H)")
    lib = build.load_library()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        # lse and delta rows padded to 64 queries, and dq's f32 workspace
        # (128 MB at B = 4, S = 4096, H = 16, D = 128), both zeroed
        sp = -(-S // 64) * 64
        scratch = torch.zeros(2 * B * H * sp, dtype=torch.float32,
                              device=q.device)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty((B, S, H), dtype=torch.float32,
                              device=q.device)
        dq_acc = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), B, S, H,
            k.shape[2], D, int(causal), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
