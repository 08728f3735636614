"""Plain PyTorch versions of the port's kernels (the allclose references).

The paged-attention and RMSNorm forwards and the two scans mirror the jnp
oracles of the same name in ``repro.kernels.ref`` (the scans also return
the final state, which serving keeps); the flash-attention forward and backward
mirror the JAX model's ``_flash_fwd_scan`` and ``_flash_vjp_bwd``
(``repro.models.layers``), and the RMSNorm backward the gradient JAX takes
of ``layers.rmsnorm``.  The two scans' backwards (:func:`mamba_scan_bwd_ref`,
:func:`slstm_bwd_ref`) are explicit reverse-time loops: the gradients JAX
takes of its ``lax.scan`` twins, term by term.  On the CPU the model runs
through these; on the card ``chip_smoke.py`` holds each hand-written kernel
against them on the same inputs.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Gather-decode/verify attention over a paged KV pool.

    q: (B, H, D) single-token decode, or (B, K, H, D) for K consecutive
    query tokens per row; k_pages/v_pages: (P, bs, Hkv, D); tables: (B, W)
    physical page ids; lengths: (B,) valid KV tokens for the FIRST query
    of each row — query t sees ``lengths[b] + t`` tokens.  Gathers each
    row's pages into logical order and runs masked softmax attention in
    f32.  Returns q's rank and dtype.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, K, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    W = tables.shape[1]
    g = H // Hkv
    t = tables.long()
    kg = k_pages[t].reshape(B, W * bs, Hkv, D).float()
    vg = v_pages[t].reshape(B, W * bs, Hkv, D).float()
    qg = q.reshape(B, K, Hkv, g, D).float()
    s = torch.einsum("bthgd,bkhd->bthgk", qg, kg) / math.sqrt(D)
    pos = torch.arange(W * bs, device=q.device)
    lens = lengths.long()[:, None] + torch.arange(K, device=q.device)[None]
    valid = pos[None, None, :] < lens[..., None]          # (B, K, W*bs)
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bthgk,bkhd->bthgd", w, vg)
    out = out.reshape(B, K, H, D).to(q.dtype)
    return out[:, 0] if squeeze else out


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` over the last axis, with f32
    statistics, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of :func:`rmsnorm_ref` given the output cotangent ``dy``.

    With ``r = rsqrt(mean(x**2) + eps)`` per row, in f32:
    ``dx = r*s*dy - x * r**3 * mean(x*s*dy)`` (cast to x's dtype) and
    ``dscale = sum over rows of dy*x*r`` (cast to scale's dtype).
    """
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    dyf = dy.float().reshape(-1, d)
    sf = scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    sdy = sf * dyf
    c = (xf * sdy).mean(dim=-1, keepdim=True)
    dx = r * sdy - xf * (r * r * r) * c
    dscale = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


def _kv_chunk(Sk: int, k_chunk: int) -> int:
    """The largest chunk <= ``k_chunk`` that divides ``Sk`` (as JAX's
    ``_flash_fwd_scan`` picks it)."""
    C = min(k_chunk, Sk)
    while Sk % C:
        C -= 1
    return C


def _causal_mask(S: int, c0: int, C: int, device) -> torch.Tensor:
    """(S, C) bool: query position >= key position ``c0 + j``."""
    q_pos = torch.arange(S, device=device)
    kv_pos = c0 + torch.arange(C, device=device)
    return q_pos[:, None] >= kv_pos[None, :]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            k_chunk: int = 1024):
    """Flash-attention forward: online softmax over KV chunks, in f32.

    q: (B, S, H, D); k/v: (B, S, Hkv, D), q head ``h`` reads kv head
    ``h // (H // Hkv)``.  The chunked scan of JAX's ``_flash_fwd_scan``
    (``repro.models.layers``), chunk for chunk.  Returns ``out`` (q's shape
    and dtype) and ``lse`` (B, S, H) f32, the log-sum-exp of each query
    row's scaled scores (``-inf`` for a row that sees no key).
    """
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    C = _kv_chunk(Sk, k_chunk)
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, S, Hkv, g, D)
    acc = torch.zeros((B, S, Hkv, g, D), device=q.device)
    m = torch.full((B, S, Hkv, g), float("-inf"), device=q.device)
    l = torch.zeros((B, S, Hkv, g), device=q.device)
    for c0 in range(0, Sk, C):
        kb = k[:, c0:c0 + C].float()
        vb = v[:, c0:c0 + C].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb)
        if causal:
            mask = _causal_mask(S, c0, C, q.device)
            s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                   vb)
        m = m_new
    l = l.clamp(min=1e-30)
    out = (acc / l[..., None]).reshape(B, S, H, D).to(q.dtype)
    lse = torch.where(torch.isfinite(m), m + torch.log(l),
                      torch.full_like(m, float("-inf")))
    return out, lse.reshape(B, S, H)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, k_chunk: int = 1024):
    """Flash-attention backward from the forward's residuals, in f32.

    JAX's ``_flash_vjp_bwd``: ``delta = rowsum(out * dout)``; per KV chunk,
    P is recomputed from ``lse``, ``dV = P^T dO``, ``dS = P (dO V^T -
    delta) * scale``, ``dK = dS^T Q`` (summed over the g query heads of
    each kv head) and ``dQ += dS K``.  Returns (dq, dk, dv) in the dtypes
    of q, k and v.
    """
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    C = _kv_chunk(Sk, k_chunk)
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Hkv, g, D)
    og = out.float().reshape(B, S, Hkv, g, D)
    dog = dout.float().reshape(B, S, Hkv, g, D)
    delta = (og * dog).sum(dim=-1)                         # (B, S, Hkv, g)
    lse = lse.reshape(B, S, Hkv, g)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    dq = torch.zeros((B, S, Hkv, g, D), device=q.device)
    dks, dvs = [], []
    for c0 in range(0, Sk, C):
        kb = k[:, c0:c0 + C].float()
        vb = v[:, c0:c0 + C].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg * scale, kb)
        if causal:
            mask = _causal_mask(S, c0, C, q.device)
            s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
        p = torch.where(torch.isfinite(s), torch.exp(s - lse_safe[..., None]),
                        torch.zeros_like(s))
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dog))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qg))
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq.reshape(B, S, H, D).to(q.dtype), dk, dv


def mamba_scan_ref(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor):
    """Sequential selective scan, in f32.

    dt/xc: (B, S, d) step sizes (post-softplus) and activations; bm/cm:
    (B, S, N); a: (d, N), negative.  From ``h = 0``, per step
    ``h = exp(dt_t a) h + (dt_t xc_t) bm_t`` and ``y_t = h . cm_t``.
    Returns ``y`` (B, S, d) and the state after the last step ``h``
    (B, d, N).
    """
    B, S, d = dt.shape
    h = torch.zeros((B, d, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * a)
        dbx = (dt[:, t] * xc[:, t])[..., None] * bm[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, dim=1), h


def slstm_step(gates: torch.Tensor, state):
    """One sLSTM update from the full gate pre-activations ``gates`` (B, 4d)
    ``[i|f|z|o]`` and ``state = (h, c, n, m)``, (B, d) each: stabilised
    exponential gating, ``n`` clamped at 1e-6.  Returns the new state."""
    _, c0, n0, m0 = state
    it, ft, zt, ot = gates.chunk(4, dim=-1)
    lf = torch.nn.functional.logsigmoid(ft)
    m1 = torch.maximum(lf + m0, it)
    ip = torch.exp(it - m1)
    fp = torch.exp(lf + m0 - m1)
    c1 = fp * c0 + ip * torch.tanh(zt)
    n1 = torch.clamp(fp * n0 + ip, min=1e-6)
    h1 = torch.sigmoid(ot) * c1 / n1
    return h1, c1, n1, m1


def slstm_recurrent(h: torch.Tensor, r_h: torch.Tensor) -> torch.Tensor:
    """The block-diagonal recurrent term: h (B, d) through r_h (H, dh,
    4dh), regrouped from per-head ``[i|f|z|o]`` to the (B, 4d) gate
    layout."""
    B, d = h.shape
    H, dh = r_h.shape[:2]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), r_h)
    return rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)


def slstm_ref(gx: torch.Tensor, r_h: torch.Tensor):
    """Sequential sLSTM over S, in f32.

    gx: (B, S, 4d) input gate pre-activations ``[i|f|z|o]``; r_h: (H, dh,
    4dh) block-diagonal recurrent weights.  From ``h = c = n = 0`` and
    ``m = -1e9``.  Returns ``h`` (B, S, d) and the final state ``(h, c, n,
    m)``, (B, d) each.
    """
    B, S, d4 = gx.shape
    z = torch.zeros((B, d4 // 4), dtype=torch.float32, device=gx.device)
    state = (z, z, z, torch.full_like(z, -1e9))
    hs = []
    for t in range(S):
        state = slstm_step(gx[:, t] + slstm_recurrent(state[0], r_h), state)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


# steps between the states the plain backward keeps (the kernel's tile)
MAMBA_BWD_CHUNK = 32


def _mamba_step(h, dt_t, xc_t, bm_t, a):
    """One selective-scan update: ``exp(dt_t a) h + (dt_t xc_t) bm_t``."""
    return torch.exp(dt_t[..., None] * a) * h \
        + (dt_t * xc_t)[..., None] * bm_t[:, None, :]


def mamba_scan_bwd_ref(dt: torch.Tensor, xc: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor = None):
    """Gradients of :func:`mamba_scan_ref` given the cotangents of ``y``
    (``dy``, (B, S, d)) and of the final state (``dh_last``, (B, d, N);
    None is zero), in f32.

    The state's cotangent runs backwards from ``g = dh_last``:
    ``g_t = dy_t C_t + exp(dt_{t+1} a) g_{t+1}``, and with ``e_t =
    exp(dt_t a)``: ``d_xc_t = dt_t sum_n g_t B_t``, ``d_dt_t = sum_n g_t (a
    e_t h_{t-1} + xc_t B_t)``, ``d_B_t = sum_d g_t dt_t xc_t``, ``d_C_t =
    sum_d dy_t h_t`` and ``d_a = sum_{b,t} g_t dt_t e_t h_{t-1}``.  The
    states are kept every :data:`MAMBA_BWD_CHUNK` steps and a chunk's are
    recomputed from its checkpoint before its reverse sweep, as the kernel
    does.
    Returns ``(d_dt, d_xc, d_bm, d_cm, d_a)``.
    """
    B, S, d = dt.shape
    chunk = MAMBA_BWD_CHUNK
    h = torch.zeros((B, d, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ckpts = []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(h)
        h = _mamba_step(h, dt[:, t], xc[:, t], bm[:, t], a)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float()
    d_dt, d_xc = torch.empty_like(dt), torch.empty_like(xc)
    d_bm, d_cm = torch.empty_like(bm), torch.empty_like(cm)
    d_a = torch.zeros_like(a)
    for c in reversed(range(len(ckpts))):
        t0 = c * chunk
        hs = [ckpts[c]]                      # hs[i]: the state after t0+i-1
        for t in range(t0, min(S, t0 + chunk)):
            hs.append(_mamba_step(hs[-1], dt[:, t], xc[:, t], bm[:, t], a))
        for t in reversed(range(t0, min(S, t0 + chunk))):
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            e = torch.exp(dt[:, t, :, None] * a)
            g = g + dy[:, t, :, None] * cm[:, t, None, :]
            gb = (g * bm[:, t, None, :]).sum(dim=-1)          # (B, d)
            w = g * e * h_prev
            d_xc[:, t] = dt[:, t] * gb
            d_dt[:, t] = (w * a).sum(dim=-1) + xc[:, t] * gb
            d_bm[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * xc[:, t])
            d_cm[:, t] = torch.einsum("bdn,bd->bn", h_t, dy[:, t])
            d_a += torch.einsum("bdn,bd->dn", w, dt[:, t])
            g = e * g
    return d_dt, d_xc, d_bm, d_cm, d_a


def _max_share(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of ``max(x, y)``'s cotangent that reaches x, by JAX's rule
    for ``jnp.maximum``: 1 where x is larger, 0 where smaller, 1/2 at a
    tie."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def slstm_step_bwd(gates: torch.Tensor, prev, new, gh, dc, dn, dm):
    """The backward of :func:`slstm_step`, term by term as JAX
    differentiates ``xlstm._slstm_cell``: the stabiliser ``m`` carries a
    gradient, ``max(lf + m0, i)`` and the ``n`` clamp split theirs by
    :func:`_max_share`.

    ``gates`` (B, 4d) ``[i|f|z|o]``; ``prev = (c0, n0, m0)`` and ``new =
    (c1, n1, m1)``, (B, d) each; ``gh``, ``dc``, ``dn``, ``dm`` the
    cotangents of ``h1``, ``c1``, ``n1``, ``m1``.  Returns ``(dgates, dc0,
    dn0, dm0)``.
    """
    c0, n0, m0 = prev
    c1, n1, m1 = new
    it, ft, zt, ot = gates.chunk(4, dim=-1)
    u = torch.nn.functional.logsigmoid(ft) + m0
    ip = torch.exp(it - m1)
    fp = torch.exp(u - m1)
    tz = torch.tanh(zt)
    so = torch.sigmoid(ot)
    # h1 = (so * c1) / n1
    dq = gh / n1
    dn1 = dn - gh * (so * c1) / (n1 * n1)
    dc1 = dc + dq * so
    dnn = dn1 * _max_share(fp * n0 + ip, torch.full_like(n0, 1e-6))
    dfp = dc1 * c0 + dnn * n0
    dip = dc1 * tz + dnn
    dm1 = dm - dfp * fp - dip * ip
    wu = _max_share(u, it)
    du = dfp * fp + dm1 * wu
    di = dip * ip + dm1 * (1.0 - wu)
    df = du * torch.sigmoid(-ft)
    dz = dc1 * ip * (1.0 - tz * tz)
    do = dq * c1 * so * (1.0 - so)
    return torch.cat([di, df, dz, do], dim=-1), dc1 * fp, dnn * fp, du


def slstm_recurrent_bwd(dgates: torch.Tensor,
                        r_h: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`slstm_recurrent`: (B, 4d) gate cotangents
    -> (B, d), head k's ``r_h[k] @ dgates[head k]``."""
    B, d4 = dgates.shape
    H, dh = r_h.shape[:2]
    dg = dgates.reshape(B, 4, H, dh).transpose(1, 2).reshape(B, H, 4 * dh)
    return torch.einsum("bhe,hke->bhk", dg, r_h).reshape(B, d4 // 4)


def slstm_r_h_grad(h: torch.Tensor, dgates: torch.Tensor,
                   H: int) -> torch.Tensor:
    """``d_r_h[k] = sum_{b,t} h_{t-1}[head k]^T dgates_t[head k]`` from the
    outputs h (B, S, d) (``h_{-1} = 0``) and the gate cotangents (B, S,
    4d): one batched product over all steps, (H, dh, 4dh)."""
    B, S, d = h.shape
    dh = d // H
    h_prev = torch.nn.functional.pad(h, (0, 0, 1, 0))[:, :S]
    dg = dgates.reshape(B, S, 4, H, dh).transpose(2, 3).reshape(
        B * S, H, 4 * dh)
    return torch.einsum("nhk,nhe->hke", h_prev.reshape(B * S, H, dh), dg)


def slstm_bwd_ref(gx: torch.Tensor, r_h: torch.Tensor, dh: torch.Tensor,
                  d_final=None):
    """Gradients of :func:`slstm_ref` given the cotangents of its outputs
    ``dh`` (B, S, d) and of its final ``(h, c, n, m)`` (``d_final``, a
    tuple of (B, d) tensors; None is zero), in f32: the forward is run
    again keeping every step's gates and state, then one reverse sweep of
    :func:`slstm_step_bwd` with the recurrent cotangent ``r_h @ dgates``
    carried into the step before.  Returns ``(d_gx, d_r_h)``.
    """
    B, S, d4 = gx.shape
    z = torch.zeros((B, d4 // 4), dtype=torch.float32, device=gx.device)
    states = [(z, z, z, torch.full_like(z, -1e9))]
    gates = []
    for t in range(S):
        gates.append(gx[:, t] + slstm_recurrent(states[-1][0], r_h))
        states.append(slstm_step(gates[-1], states[-1]))
    dh_c, dc, dn, dm = (z, z, z, z) if d_final is None else d_final
    d_gx = torch.empty_like(gx)
    for t in reversed(range(S)):
        d_gx[:, t], dc, dn, dm = slstm_step_bwd(
            gates[t], states[t][1:], states[t + 1][1:], dh[:, t] + dh_c,
            dc, dn, dm)
        dh_c = slstm_recurrent_bwd(d_gx[:, t], r_h)
    hs = torch.stack([s[0] for s in states[1:]], dim=1)
    return d_gx, slstm_r_h_grad(hs, d_gx, r_h.shape[0])
