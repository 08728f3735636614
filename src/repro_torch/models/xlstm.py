"""xLSTM blocks of the port (arXiv:2405.04517): mLSTM and sLSTM.

The counterpart of ``repro.models.xlstm``.  The mLSTM runs in JAX's
chunkwise-parallel form (attention-like mixing inside fixed-size chunks,
a recurrent ``(C, n, m)`` carry across them) in plain PyTorch, since the
JAX package has no kernel for it, and trains through autograd.  The
sLSTM's sequential recurrence goes through
:func:`repro_torch.kernels.ops.slstm_scan` (the CUDA kernels on the card,
their plain versions on the CPU), which also returns the final state and
carries gradients to ``w_x``, ``bias`` and ``r_h`` through its backward;
the single-token decode steps of both blocks are plain PyTorch, as in JAX,
and their ``_multi`` forms step them over the K tokens of a speculative
verify or a rollback replay, freezing each row past its real tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import decode_scan, dense_init

State = Dict[str, torch.Tensor]


def _xcfg(cfg: ModelConfig) -> XLSTMConfig:
    return cfg.xlstm or XLSTMConfig()


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width dm, heads H, head dim DH) of the mLSTM block."""
    dm = int(_xcfg(cfg).proj_factor_mlstm * cfg.d_model)
    H = cfg.num_heads
    dm -= dm % (H * 2)                  # keep the head dim even
    return dm, H, dm // H


def _init_linears(gen: torch.Generator, *linears: nn.Linear) -> None:
    for lin in linears:
        lin.weight.copy_(dense_init(gen, lin.in_features, lin.out_features,
                                    lin.weight.dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """mLSTM weights (``repro.models.xlstm.init_mlstm``): ``up``, ``wq``,
    ``wk``, ``wv``, ``down`` in the model dtype, the gate projection
    ``w_if`` and its bias ``b_if`` (2H,) in f32."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        dm, H, _ = mlstm_dims(cfg)
        self.cfg = cfg
        self.up = nn.Linear(d, 2 * dm, bias=False, dtype=dtype)
        self.wq = nn.Linear(dm, dm, bias=False, dtype=dtype)
        self.wk = nn.Linear(dm, dm, bias=False, dtype=dtype)
        self.wv = nn.Linear(dm, dm, bias=False, dtype=dtype)
        self.w_if = nn.Linear(dm, 2 * H, bias=False, dtype=torch.float32)
        self.b_if = nn.Parameter(torch.empty((2 * H,), dtype=torch.float32))
        self.down = nn.Linear(dm, d, bias=False, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """JAX's init: dense N(0, 1/d_in); input-gate bias 0, forget-gate
        bias 3."""
        _init_linears(gen, self.up, self.wq, self.wk, self.wv, self.w_if,
                      self.down)
        H = self.b_if.shape[0] // 2
        self.b_if[:H] = 0.0
        self.b_if[H:] = 3.0


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """Zero mLSTM state: ``C`` (batch, H, DH, DH), ``n`` (batch, H, DH),
    ``m`` (batch, H) at -1e9; all f32."""
    _, H, DH = mlstm_dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, DH, DH), **kw),
            "n": torch.zeros((batch, H, DH), **kw),
            "m": torch.full((batch, H), -1e9, **kw)}


def _mlstm_qkvif(m: MLSTM, x: torch.Tensor):
    """x (B, S, d) -> q, k, v (B, H, S, DH), log-gates li, lf (B, H, S)
    and the output gate's input z (B, S, dm)."""
    B, S, _ = x.shape
    _, H, DH = mlstm_dims(m.cfg)
    xm, z = m.up(x).chunk(2, dim=-1)

    def heads(lin):
        return lin(xm).reshape(B, S, H, DH).transpose(1, 2)

    gates = F.linear(xm.float(), m.w_if.weight) + m.b_if
    li, lf = gates.chunk(2, dim=-1)                        # (B, S, H)
    return heads(m.wq), heads(m.wk), heads(m.wv), li.transpose(1, 2), \
        F.logsigmoid(lf).transpose(1, 2), z


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk of the stabilised chunkwise mLSTM (``_mlstm_chunk``).

    q/k/v: (B, H, Q, DH) f32; li/lf: (B, H, Q); state = (C, n, m).
    Returns (h (B, H, Q, DH), new state)."""
    Q, DH = q.shape[2], q.shape[3]
    C0, n0, m0 = state
    csum = torch.cumsum(lf, dim=-1)                        # (B, H, Q)
    Dtil = csum[..., :, None] - csum[..., None, :] + li[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    Dtil = Dtil.masked_fill(~mask, float("-inf"))
    b = csum + m0[..., None]
    m_new = torch.maximum(Dtil.amax(dim=-1), b)            # (B, H, Q)
    W = torch.exp(Dtil - m_new[..., None])
    a = torch.exp(b - m_new)
    scale = 1.0 / math.sqrt(DH)
    qk = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    num = torch.einsum("bhts,bhsd->bhtd", W * qk, v) \
        + a[..., None] * torch.einsum("bhde,bhtd->bhte", C0, q * scale)
    den = torch.einsum("bhts,bhsd,bhtd->bht", W, k * scale, q) \
        + a * torch.einsum("bhd,bhtd->bht", n0, q * scale)
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    h = num / den[..., None]
    g_end = csum[..., -1]                                  # (B, H)
    m_end = torch.maximum(g_end + m0,
                          (g_end[..., None] - csum + li).amax(dim=-1))
    w_end = torch.exp(g_end[..., None] - csum + li - m_end[..., None])
    decay = torch.exp(g_end + m0 - m_end)
    C1 = decay[..., None, None] * C0 \
        + torch.einsum("bhs,bhsd,bhse->bhde", w_end, k, v)
    n1 = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", w_end, k)
    return h, (C1, n1, m_end)


def mlstm_block(m: MLSTM, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """Full-sequence chunkwise mLSTM over x (B, S, d): returns the output
    (B, S, d) and the state after the S steps (``mlstm_block`` with
    ``return_state=True``).  The tail chunk is padded with input gate
    -1e9 and forget gate 0, which leaves the state exact."""
    B, S, _ = x.shape
    dm, H, DH = mlstm_dims(m.cfg)
    q, k, v, li, lf, z = _mlstm_qkvif(m, x)
    q, k, v = q.float(), k.float(), v.float()
    Q = min(_xcfg(m.cfg).chunk_size, S)
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, pad), value=-1e9)
        lf = F.pad(lf, (0, pad))
    st = init_mlstm_state(m.cfg, B, x.device)
    state = (st["C"], st["n"], st["m"])
    hs = []
    for c0 in range(0, S + pad, Q):
        sl = slice(c0, c0 + Q)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                li[..., sl], lf[..., sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :S]
    h = h.transpose(1, 2).reshape(B, S, dm).to(x.dtype) * F.silu(z)
    return m.down(h), dict(zip("Cnm", state))


def mlstm_decode(m: MLSTM, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """One token per row (``mlstm_decode``): x (B, 1, d) and the state of
    those B rows -> (out (B, 1, d), new state); the state is not written
    here."""
    B = x.shape[0]
    dm, _, DH = mlstm_dims(m.cfg)
    q, k, v, li, lf, z = _mlstm_qkvif(m, x)
    q, k, v = (t[:, :, 0].float() for t in (q, k, v))     # (B, H, DH)
    li, lf = li[..., 0], lf[..., 0]                        # (B, H)
    C0, n0, m0 = state["C"], state["n"], state["m"]
    m1 = torch.maximum(lf + m0, li)
    fp = torch.exp(lf + m0 - m1)
    ip = torch.exp(li - m1)
    scale = 1.0 / math.sqrt(DH)
    C1 = fp[..., None, None] * C0 + ip[..., None, None] \
        * torch.einsum("bhd,bhe->bhde", k, v)
    n1 = fp[..., None] * n0 + ip[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", C1, q * scale)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n1, q * scale).abs(),
                        torch.exp(-m1))
    h = (num / den[..., None]).reshape(B, 1, dm).to(x.dtype) * F.silu(z)
    return m.down(h), {"C": C1, "n": n1, "m": m1}


def mlstm_decode_multi(m: MLSTM, x: torch.Tensor, state: State,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, State]:
    """K tokens per row (``mlstm_decode_multi``): K :func:`mlstm_decode`
    steps, row b's ``C``, ``n``, ``m`` frozen after its first ``valid[b]``
    tokens (:func:`repro_torch.models.layers.decode_scan`)."""
    return decode_scan(lambda xt, st: mlstm_decode(m, xt, st), x, state,
                       valid)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """sLSTM weights (``repro.models.xlstm.init_slstm``): the input gate
    projection ``w_x`` and ``bias`` in f32, the block-diagonal recurrent
    weights ``r_h`` (H, dh, 4dh) in f32 (JAX's layout), and the gated FFN
    ``up_g``, ``up_v``, ``down`` in the model dtype."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        df = int(_xcfg(cfg).proj_factor_slstm * d)
        dh = d // H
        self.cfg = cfg
        self.w_x = nn.Linear(d, 4 * d, bias=False, dtype=torch.float32)
        self.r_h = nn.Parameter(torch.empty((H, dh, 4 * dh),
                                            dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty((4 * d,), dtype=torch.float32))
        self.up_g = nn.Linear(d, df, bias=False, dtype=dtype)
        self.up_v = nn.Linear(d, df, bias=False, dtype=dtype)
        self.down = nn.Linear(df, d, bias=False, dtype=dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        """JAX's init: dense N(0, 1/d_in), ``r_h`` N(0, 1/dh), bias 0."""
        _init_linears(gen, self.w_x, self.up_g, self.up_v, self.down)
        H, dh, e = self.r_h.shape
        r = torch.randn((H, dh, e), generator=gen, device=gen.device)
        self.r_h.copy_(r / math.sqrt(dh))
        self.bias.zero_()


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """Zero sLSTM state: ``h``, ``c``, ``n`` (batch, d) and ``m`` at
    -1e9; all f32."""
    kw = dict(dtype=torch.float32, device=device)
    st = {k: torch.zeros((batch, cfg.d_model), **kw) for k in "hcn"}
    st["m"] = torch.full((batch, cfg.d_model), -1e9, **kw)
    return st


def _slstm_ffn(m: SLSTM, h: torch.Tensor) -> torch.Tensor:
    """The gated FFN after the recurrence: ``(gelu(h Wg) * (h Wv)) Wd``
    (JAX's tanh-approximated gelu)."""
    return m.down(F.gelu(m.up_g(h), approximate="tanh") * m.up_v(h))


def slstm_block(m: SLSTM, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """Sequential sLSTM over x (B, S, d), then the gated FFN: returns the
    output (B, S, d) and the final state (``slstm_block`` with
    ``return_state=True``).  The input gates of all steps are one f32
    matmul; the recurrence is ``ops.slstm_scan``."""
    gx = F.linear(x.float(), m.w_x.weight) + m.bias            # (B, S, 4d)
    h, state = ops.slstm_scan(gx.contiguous(), m.r_h.contiguous())
    return _slstm_ffn(m, h.to(x.dtype)), dict(zip("hcnm", state))


def slstm_decode(m: SLSTM, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """One token per row (``slstm_decode``): x (B, 1, d) and the state of
    those B rows -> (out (B, 1, d), new state); the state is not written
    here."""
    gx = F.linear(x[:, 0].float(), m.w_x.weight) + m.bias
    old = tuple(state[k] for k in "hcnm")
    new = ref.slstm_step(gx + ref.slstm_recurrent(old[0], m.r_h), old)
    return _slstm_ffn(m, new[0][:, None].to(x.dtype)), dict(zip("hcnm", new))


def slstm_decode_multi(m: SLSTM, x: torch.Tensor, state: State,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, State]:
    """K tokens per row (``slstm_decode_multi``): K :func:`slstm_decode`
    steps, row b's ``h``, ``c``, ``n``, ``m`` frozen after its first
    ``valid[b]`` tokens (:func:`repro_torch.models.layers.decode_scan`)."""
    return decode_scan(lambda xt, st: slstm_decode(m, xt, st), x, state,
                       valid)
