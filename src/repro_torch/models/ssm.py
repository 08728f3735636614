"""Mamba-1 selective SSM block of the port (jamba's sequence mixer).

The counterpart of ``repro.models.ssm``.  The full-sequence path
(:func:`mamba_core`) computes the step sizes ``dt`` for the whole sequence
in f32 and hands the scan to :func:`repro_torch.kernels.ops.mamba_scan`
(the CUDA kernels on the card, their plain versions on the CPU), which
also returns the state after the last step and carries gradients: every
weight of the block (``conv_w``, ``dt_bias``, ``A_log``, ``D`` and the
projections) trains, the scan's through its backward kernel, the rest
through autograd; :func:`mamba_decode` is the
single-token update in plain PyTorch, as in JAX, and
:func:`mamba_decode_multi` steps it over the K tokens of a speculative
verify or a rollback replay.

One difference from ``repro.models.ssm._mamba_core`` is deliberate: JAX
pads the sequence to a multiple of its 128-step chunk, and on a pad step
``dt = softplus(dt_bias) ~ 0.01`` is not zero, so for a prompt longer than
128 tokens and not a multiple of 128 its returned state has decayed by
``exp(dt A)`` once per pad step (its outputs ``y`` are right).  The port
scans exactly the S real steps, so its state is the one JAX's own
sequential oracle (``mamba_ref_sequential``, ``mamba_decode`` stepped
token by token) computes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import decode_scan, dense_init

State = Dict[str, torch.Tensor]


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_in, d_state N, d_conv K, dt_rank R) of a config's Mamba block."""
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or math.ceil(cfg.d_model / 16)
    return d_in, mc.d_state, mc.d_conv, dt_rank


class Mamba(nn.Module):
    """Mamba weights (``repro.models.ssm.init_mamba``): projections as
    ``nn.Linear`` (stored ``(d_out, d_in)``), the rest in JAX's layout —
    ``conv_w`` (K, d_in), ``A_log`` (d_in, N) and the f32 ``dt_bias`` and
    ``D``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        d_in, N, K, R = mamba_dims(cfg)
        f32 = torch.float32
        self.cfg = cfg
        self.in_proj = nn.Linear(d, 2 * d_in, bias=False, dtype=dtype)
        self.conv_w = nn.Parameter(torch.empty((K, d_in), dtype=dtype))
        self.conv_b = nn.Parameter(torch.empty((d_in,), dtype=dtype))
        self.x_proj = nn.Linear(d_in, R + 2 * N, bias=False, dtype=dtype)
        self.dt_proj = nn.Linear(R, d_in, bias=False, dtype=dtype)
        self.dt_bias = nn.Parameter(torch.empty((d_in,), dtype=f32))
        self.A_log = nn.Parameter(torch.empty((d_in, N), dtype=f32))
        self.D = nn.Parameter(torch.empty((d_in,), dtype=f32))
        self.out_proj = nn.Linear(d_in, d, bias=False, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """JAX's init: dense N(0, 1/d_in), ``conv_w`` N(0, 1/K), ``A = -(1
        .. N)`` per channel, ``dt_bias`` -4.6 (softplus ~ 0.01), ``D`` one,
        ``conv_b`` zero."""
        d_in, N, K, _ = mamba_dims(self.cfg)
        for lin in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            lin.weight.copy_(dense_init(gen, lin.in_features,
                                        lin.out_features, lin.weight.dtype))
        w = torch.randn((K, d_in), generator=gen, device=gen.device)
        self.conv_w.copy_(w / math.sqrt(K))
        self.conv_b.zero_()
        self.dt_bias.fill_(-4.6)
        a = torch.arange(1, N + 1, dtype=torch.float32, device=gen.device)
        self.A_log.copy_(torch.log(a).expand(d_in, N))
        self.D.fill_(1.0)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> State:
    """Zero decode state of ``batch`` rows: ``ssm`` (batch, d_in, N) f32
    and the conv window ``conv`` (batch, K - 1, d_in) in ``dtype``."""
    d_in, N, K, _ = mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, d_in, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, K - 1, d_in), dtype=dtype,
                                device=device)}


def conv_causal(m: Mamba, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (B, S, d_in): ``out[t] = sum_k
    xpad[t + k] * conv_w[k] + conv_b``, left-padded with K - 1 zeros;
    summed in f32, returned in x's dtype (no cuDNN, so no TF32)."""
    K = m.conv_w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0)).float()
    w = m.conv_w.float()
    out = sum(xp[:, k:k + S] * w[k] for k in range(K))
    return (out + m.conv_b.float()).to(x.dtype)


def _step_sizes(m: Mamba, dt_in: torch.Tensor) -> torch.Tensor:
    """``softplus(dt_in @ dt_proj + dt_bias)`` in f32."""
    return F.softplus(F.linear(dt_in, m.dt_proj.weight.float())
                      + m.dt_bias)


def mamba_core(m: Mamba, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """Full-sequence Mamba over x (B, S, d): returns the output (B, S, d)
    and the decode state after the S steps (``ssm`` and the conv window),
    as ``repro.models.ssm._mamba_core`` with ``return_state=True``
    computes them (save the state on a padded prompt; see the module
    note)."""
    B, S, _ = x.shape
    d_in, N, K, R = mamba_dims(m.cfg)
    xi, z = m.in_proj(x).chunk(2, dim=-1)
    xc = F.silu(conv_causal(m, xi))                       # (B, S, d_in)
    dt_in, bm, cm = m.x_proj(xc).float().split([R, N, N], dim=-1)
    dt = _step_sizes(m, dt_in)                            # (B, S, d_in)
    a = -torch.exp(m.A_log)
    y, h_last = ops.mamba_scan(dt.contiguous(), xc.float().contiguous(),
                               bm.contiguous(), cm.contiguous(),
                               a.contiguous())
    # the gating chain in the model dtype, as JAX keeps it
    y = y.to(x.dtype) + m.D.to(x.dtype) * xc
    y = y * F.silu(z)
    out = m.out_proj(y)
    conv = F.pad(xi, (0, 0, K - 1, 0))[:, S:S + K - 1] if S < K - 1 \
        else xi[:, S - (K - 1):S]
    return out, {"ssm": h_last, "conv": conv.to(x.dtype)}


def mamba_decode(m: Mamba, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """One token per row (``repro.models.ssm.mamba_decode``): x (B, 1, d)
    and the state of those B rows -> (out (B, 1, d), new state).  The conv
    and the SSM update run in f32; the state is not written here."""
    _, N, _, R = mamba_dims(m.cfg)
    xi, z = m.in_proj(x[:, 0]).chunk(2, dim=-1)           # (B, d_in)
    window = torch.cat([state["conv"], xi[:, None]], dim=1)
    xc = torch.einsum("bkd,kd->bd", window.float(), m.conv_w.float())
    xc = F.silu(xc + m.conv_b.float())
    dt_in, bm, cm = F.linear(xc, m.x_proj.weight.float()).split(
        [R, N, N], dim=-1)
    dt = _step_sizes(m, dt_in)                            # (B, d_in)
    a = -torch.exp(m.A_log)
    h = torch.exp(dt[..., None] * a) * state["ssm"] \
        + (dt * xc)[..., None] * bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cm) + m.D * xc
    y = (y * F.silu(z.float())).to(x.dtype)
    return m.out_proj(y)[:, None], \
        {"ssm": h, "conv": window[:, 1:].to(state["conv"].dtype)}


def mamba_decode_multi(m: Mamba, x: torch.Tensor, state: State,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, State]:
    """K tokens per row (``repro.models.ssm.mamba_decode_multi``): x (B,
    K, d) -> (out (B, K, d), new state), K :func:`mamba_decode` steps in
    order; row b's ``ssm`` and ``conv`` freeze after its first
    ``valid[b]`` tokens (:func:`repro_torch.models.layers.decode_scan`)."""
    return decode_scan(lambda xt, st: mamba_decode(m, xt, st), x, state,
                       valid)
