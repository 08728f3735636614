"""Int8 error-feedback compression for the cross-pod reduction
(``repro.optim.compression``).

Across pods bandwidth is the scarce resource, so the cross-pod gradient
mean exchanges int8-quantized tensors point to point (1 byte an element
on the wire instead of 2-4) and keeps the quantization error in an
error-feedback buffer that the caller re-injects the next step.  For P
pods it is a recursive-doubling ladder of log2(P) exchanges with the rank
``i ^ (1 << r)`` of the pod group, re-quantizing at each rung.

Each rung packs every tensor's int8 values into one buffer and their
per-tensor scales into one f32 vector, and swaps both with the partner in
one ``batch_isend_irecv``.  The quantizer is JAX's compiled one bit for
bit: the scale is ``max(|x|, 1e-12) / 127`` in f32, which XLA computes
under ``jit`` (where JAX's exchange and ladder run) as a product with the
f32 reciprocal of 127; values are rounded half to even and clipped to
+-127.  The ladder's sums round each product and each sum; XLA contracts
some of JAX's into fused multiply-adds (which ones depends on its
fusion), so the two packages' means and errors differ in the last bit of
the largest operand.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ltfb import (concat, global_rank, split, swap_buffers,
                                   tree_leaves, tree_unflatten)

Params = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns ``(q, scale)``,
    ``scale`` a 0-dim f32 tensor."""
    x32 = x.to(torch.float32)
    # XLA's form of ``/ 127.0``: the product with 1/127 rounded to f32
    scale = torch.clamp(x32.abs().max(), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in f32."""
    return q.to(torch.float32) * scale


def init_error_feedback(params: Params) -> Params:
    """Zero f32 error-feedback buffers shaped as ``params``."""
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                   for p in tree_leaves(params)])


def compression_ratio(dtype: torch.dtype = torch.float32) -> float:
    """Wire bytes saved: ``dtype``'s element size over int8's."""
    return torch.empty((), dtype=dtype).element_size() / 1.0


def compressed_psum_pod(grads: Params, error: Params, group=None,
                        num_pods: int = 2) -> Tuple[Params, Params]:
    """Cross-pod gradient mean with an int8 wire format and error
    feedback.  ``group`` is the pod group (``num_pods`` ranks, a power of
    two); every rank of it calls this with trees of the same shapes.
    Returns ``(mean_grads, new_error)``, both f32."""
    size = dist.get_world_size(group)
    if size != num_pods or num_pods & (num_pods - 1):
        raise ValueError(f"the pod ladder needs a power-of-two group of "
                         f"num_pods={num_pods} ranks, got {size}")
    me = dist.get_rank(group)
    steps = max(1, num_pods.bit_length() - 1)
    total = [g.to(torch.float32) + e
             for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    err = [torch.zeros_like(t) for t in total]
    for r in range(steps):
        qs, ss = zip(*(quantize_int8(t) for t in total))
        err = [e + (t - dequantize_int8(q, s))
               for e, t, q, s in zip(err, total, qs, ss)]
        # one int8 buffer and one f32 vector of scales each way
        got, s_o = swap_buffers([concat(qs), torch.stack(ss)],
                                global_rank(group, me ^ (1 << r)), group)
        q_o = split(got, qs)
        total = [dequantize_int8(q, s) + dequantize_int8(qo, s_o[i])
                 for i, (q, s, qo) in enumerate(zip(qs, ss, q_o))]
    mean = [t / num_pods for t in total]
    return tree_unflatten(grads, mean), tree_unflatten(grads, err)
