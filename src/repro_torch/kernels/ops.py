"""Device dispatch for the port's kernels — the model's only entry to them.

A tensor on the CPU takes the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a tensor on a CUDA device takes the
hand-written kernel, whose wrapper launches it or raises.  There is no
fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode/verify attention over paged KV (see ``ref.paged_attention_ref``
    for the contract): CPU -> plain version, CUDA -> the CUDA kernel."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths)
    return pa.paged_attention(q, k_pages, v_pages, tables, lengths)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: CPU -> plain version, CUDA -> the Triton
    kernel."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    return rn.rmsnorm(x, scale, eps)
