"""Paged-attention decode/verify: the CUDA C++ kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention``, body ``_kernel``).  The kernel itself is
``csrc/paged_attention.cu`` (its source note says what bounds it — bytes
— and what its design does about that); it is compiled by ``nvcc`` for
``sm_90a`` at first use (:mod:`repro_torch.kernels.build`) and called
through ``ctypes``.  Its plain PyTorch version, which the CPU path runs
and ``chip_smoke.py`` holds the kernel against, is
:func:`paged_attention_ref`.

:func:`paged_attention` only ever launches the kernel: it raises for a
tensor that is not on a CUDA device, and for any dtype, shape or layout
the kernel does not take.  The device dispatch lives in
:func:`repro_torch.kernels.ops.paged_attention`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_ref"]

_DTYPES = (torch.float32, torch.bfloat16)
# head dims the kernel is compiled for (a template parameter)
HEAD_DIMS = (16, 64, 128)


def _check(q, k_pages, v_pages, tables, lengths) -> None:
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(
                f"paged_attention kernel: {name} must lie on q's CUDA "
                f"device {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             "contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention kernel: pools must have q's dtype "
                        f"({q.dtype}), got {k_pages.dtype}/{v_pages.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: tables and lengths must "
                        "be int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_attention kernel: q must be (B, K, H, D) and the pools "
            f"(P, bs, Hkv, D) alike; got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, K, H, D = q.shape
    _, bs, Hkv, Dk = k_pages.shape
    if Dk != D or H % Hkv or D not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel: head_dim {D} (pool {Dk}) must be one "
            f"of {HEAD_DIMS}, heads {H} a multiple of kv heads {Hkv}")
    if tables.dim() != 2 or tables.shape[0] != B or tables.shape[1] < 1 \
            or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"paged_attention kernel: tables must be (B={B}, W>=1) and "
            f"lengths (B,); got {tuple(tables.shape)}, "
            f"{tuple(lengths.shape)}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: decode/verify attention over paged KV.

    q: (B, H, D) or (B, K, H, D), float32 or bfloat16, D in
    :data:`HEAD_DIMS`; k_pages/v_pages: (P+1, bs, Hkv, D) in q's dtype;
    tables: (B, W) int32 page ids, every entry a valid page of the pool
    (the kernel does not bounds-check them); lengths: (B,) int32 >= 1,
    tokens the first query of each row sees (query t sees
    ``lengths[b] + t``).
    Returns q's shape and dtype.  Counts each launch in
    ``paged_attention.launches``.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    _check(q, k_pages, v_pages, tables, lengths)
    B, K, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    lib = build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, K, H, Hkv, D, bs, tables.shape[1],
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
