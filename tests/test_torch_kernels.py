"""The port's kernels: plain versions against the JAX oracles on the CPU,
the kernels themselves against the plain versions on a CUDA card.

On the CPU, ``repro_torch.kernels.ref`` is held against
``repro.kernels.ref`` and against the Pallas kernels run in interpret
mode, on the same numpy inputs; the differentiable ops (flash attention,
RMSNorm) against the JAX model's functions and their ``jax.vjp``; the two
scans (selective scan, sLSTM), output and final state, against the JAX
oracles, the Pallas kernels and the JAX package's stepped recurrences.
Tolerances: f32 2e-5; bf16 2e-2, compared in f32 (as
``tests/test_paged.py`` states them).  The CUDA and
Triton kernels have no CPU mode: their tests carry the ``cuda`` marker
and skip without a card (run them on one with
``python -m pytest -m cuda tests/test_torch_kernels.py``).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import slstm as sl

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _paged_case(B, H, Hkv, D, bs, W, K, seed=0, idle_row=True):
    """Random q/pools, scattered tables with null-page tails, lengths in
    range; the last row is idle (length 1, a table of null pages only)."""
    rng = np.random.default_rng(seed)
    P = B * W + 1                              # pool pages, +1 null
    q = rng.standard_normal((B, K, H, D)).astype(np.float32)
    kp = rng.standard_normal((P + 1, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P + 1, bs, Hkv, D)).astype(np.float32)
    tables = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    lengths = rng.integers(1, W * bs - K + 2, size=(B,)).astype(np.int32)
    for b in range(B):
        used = -(-(int(lengths[b]) + K - 1) // bs)
        tables[b, used:] = P
    if idle_row:
        tables[-1, :] = P
        lengths[-1] = 1
    return q, kp, vp, tables, lengths


def _torch(a, dtype="float32"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(TORCH_DT[dtype]) if t.is_floating_point() else t


HEADS = [(4, 4, 32, 4, 3),       # MHA
         (8, 2, 32, 8, 2),       # GQA 4:1
         (4, 1, 64, 4, 4)]       # MQA


@pytest.mark.parametrize("H,Hkv,D,bs,W", HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_ref_matches_jax_oracle_and_pallas(H, Hkv, D, bs, W,
                                                           dtype):
    """K in {1, 3, 5}: the plain version == the jnp oracle == the Pallas
    kernel (interpret); K = 1 also through the 3-D single-token q.  Both
    JAX sides run under ``jax.jit``, as the JAX model runs them: one
    compile per shape instead of one dispatch per jnp op."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    oracle = jax.jit(jref.paged_attention_ref)
    pallas_kernel = jax.jit(functools.partial(jops.paged_attention,
                                              interpret=True))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    for K in (1, 3, 5):
        q, kp, vp, tables, lengths = _paged_case(3, H, Hkv, D, bs, W, K,
                                                 seed=K)
        if K == 1:
            q = q[:, 0]
        jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                 jnp.asarray(vp, jdt), jnp.asarray(tables),
                 jnp.asarray(lengths))
        want = np.asarray(oracle(*jargs), np.float32)
        pallas = np.asarray(pallas_kernel(*jargs), np.float32)
        got = ref.paged_attention_ref(
            _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
            _torch(tables), _torch(lengths))
        assert got.shape == q.shape and got.dtype == TORCH_DT[dtype]
        tol = TOL[dtype]
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_pallas(d, dtype):
    """The plain version == the Pallas kernel (interpret) and its oracle."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    rng = np.random.default_rng(d)
    x = rng.standard_normal((8, 16, d)).astype(np.float32)
    s = rng.standard_normal((d,)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, js = jnp.asarray(x, jdt), jnp.asarray(s, jdt)
    pallas = np.asarray(jops.rmsnorm(jx, js), np.float32)
    want = np.asarray(jref.rmsnorm_ref(jx, js), np.float32)
    got = ref.rmsnorm_ref(_torch(x, dtype), _torch(s, dtype), 1e-6)
    assert got.dtype == TORCH_DT[dtype]
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


def test_dispatch_takes_plain_version_on_cpu_and_launches_nothing():
    q, kp, vp, tables, lengths = _paged_case(3, 8, 2, 32, 8, 2, 3)
    args = (_torch(q), _torch(kp), _torch(vp), _torch(tables),
            _torch(lengths))
    before = (pa.paged_attention.launches, rn.rmsnorm.launches)
    torch.testing.assert_close(ops.paged_attention(*args),
                               ref.paged_attention_ref(*args))
    x, s = torch.randn(4, 128), torch.randn(128)
    torch.testing.assert_close(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    assert (pa.paged_attention.launches, rn.rmsnorm.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: no fallback on a CPU tensor."""
    q, kp, vp, tables, lengths = _paged_case(2, 4, 4, 32, 4, 3, 1)
    before = (pa.paged_attention.launches, rn.rmsnorm.launches)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(_torch(q), _torch(kp), _torch(vp),
                           _torch(tables), _torch(lengths))
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(torch.randn(2, 64), torch.randn(64))
    assert (pa.paged_attention.launches, rn.rmsnorm.launches) == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA and Triton kernels have "
                    "no CPU mode")
    return torch.device("cuda")


# the kernel is built for head dims 16, 64 and 128 only
CARD_HEADS = [(4, 4, 64, 4, 3),          # MHA
              (8, 2, 64, 8, 2),          # GQA 4:1
              (4, 1, 64, 4, 4),          # MQA
              (16, 8, 128, 16, 40),      # qwen3-0.6b
              (4, 2, 16, 4, 3)]          # qwen3 smoke


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D,bs,W", CARD_HEADS)
@pytest.mark.parametrize("K", [1, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain_on_card(H, Hkv, D, bs, W, K,
                                                      dtype):
    dev = _card()
    q, kp, vp, tables, lengths = _paged_case(4, H, Hkv, D, bs, W, K)
    args = [_torch(a, dtype).to(dev) for a in (q, kp, vp)] + \
        [_torch(tables).to(dev), _torch(lengths).to(dev)]
    got = pa.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def _split_lengths(B, W, bs, K, pps):
    """Lengths for the split edge cases: a row whose reach ends exactly on
    a split boundary, one a token past it, short rows (every later split
    empty), and the idle last row."""
    edge = min(pps, W) * bs - (K - 1)
    pool = [edge, edge + 1, 2, bs, W * bs - K + 1, max(1, edge - 3)]
    lengths = [min(max(1, n), W * bs - K + 1) for n in pool]
    lengths = (lengths * B)[:B - 1] + [1]
    return np.asarray(lengths, dtype=np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 36])
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_g8_split_edges_on_card(W, K, dtype):
    """jamba's g = 8 (H = 64 over Hkv = 8, D = 128, bs = 16) at K = 1 and
    5 (K * g = 40 rows in one block), a one-page table and a serve-wide
    one whose rows end on, and one token past, a split boundary, with
    empty splits and an idle row; one launch counted."""
    dev = _card()
    B, H, Hkv, D, bs = 8, 64, 8, 128, 16
    _, pps = pa.split_plan(B, Hkv, W, pa.sm_count(dev.index or 0))
    q, kp, vp, tables, _ = _paged_case(B, H, Hkv, D, bs, W, K)
    lengths = _split_lengths(B, W, bs, K, pps)
    P = kp.shape[0] - 1
    for b, n in enumerate(lengths):
        tables[b, -(-(int(n) + K - 1) // bs):] = P
    tables[-1, :] = P
    args = [_torch(a, dtype).to(dev) for a in (q, kp, vp)] + \
        [_torch(tables).to(dev), _torch(lengths).to(dev)]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,Hkv,sms", [(8, 8, 132), (8, 1, 132), (1, 8, 132),
                                       (4, 2, 8)])
@pytest.mark.parametrize("W", [1, 2, 32, 36, 64, 1000])
def test_split_plan_covers_every_page_once(B, Hkv, sms, W):
    """The serve shapes' split plan (and a few others): every table
    column falls in exactly one split, no split starts past W, at most
    ``MAX_SPLITS`` splits, and where the table is wide enough the grid
    holds two blocks per SM."""
    splits, pps = pa.split_plan(B, Hkv, W, sms)
    assert 1 <= splits <= pa.MAX_SPLITS and pps >= 1
    starts = [s * pps for s in range(splits)]
    assert all(p < W for p in starts)
    covered = [p for s in starts for p in range(s, min(s + pps, W))]
    assert sorted(covered) == list(range(W))
    want = min(-(-2 * sms // (B * Hkv)), pa.MAX_SPLITS)
    if W >= want:
        assert splits >= want


def _split_merge(q, kp, vp, tables, lengths, pps):
    """The kernel's arithmetic written plainly: each split of ``pps``
    table columns gives a partial (m, l, acc) per accumulator row -- empty
    (m = -1e30, l = 0) where no token of the row falls in it -- and the
    partials merge as ``sum acc e^(m - M) / sum l e^(m - M)``."""
    B, K, H, D = q.shape
    _, bs, Hkv, _ = kp.shape
    W = tables.shape[1]
    g = H // Hkv
    out = torch.empty_like(q)
    for b in range(B):
        for t in range(K):
            reach = int(lengths[b]) + t
            for hq in range(H):
                h = hq // g
                parts = []
                for p0 in range(0, W, pps):
                    lo, hi = p0 * bs, min(min(p0 + pps, W) * bs, reach)
                    if lo >= hi:
                        parts.append((-1e30, 0.0, torch.zeros(D)))
                        continue
                    pos = torch.arange(lo, hi)
                    pages = tables[b, pos // bs].long()
                    k = kp[pages, pos % bs, h]
                    v = vp[pages, pos % bs, h]
                    s = k @ q[b, t, hq] / math.sqrt(D)
                    m = s.max()
                    e = torch.exp(s - m)
                    parts.append((float(m), float(e.sum()), e @ v))
                M = max(m for m, l, _ in parts if l > 0)
                L = sum(l * math.exp(m - M) for m, l, _ in parts if l > 0)
                A = sum(a * math.exp(m - M) for m, l, a in parts if l > 0)
                out[b, t, hq] = A / L
    return out


@pytest.mark.parametrize("H,Hkv,K,W,sms", [
    (16, 8, 1, 36, 132),     # qwen3's heads: 5 splits of 8 pages
    (16, 2, 5, 12, 8),       # K * g = 40 rows
    (4, 4, 1, 1, 132),       # a one-page table: one split
])
def test_split_merge_matches_plain_attention(H, Hkv, K, W, sms):
    """The split-then-merge the kernel computes, over the plan's
    partition, equals ``paged_attention_ref`` within f32 1e-6, over empty
    splits, an idle row and rows ending on a split boundary."""
    B, D, bs = 4, 16, 4
    _, pps = pa.split_plan(B, Hkv, W, sms)
    q, kp, vp, tables, _ = _paged_case(B, H, Hkv, D, bs, W, K, seed=3)
    lengths = _split_lengths(B, W, bs, K, pps)
    P = kp.shape[0] - 1
    for b, n in enumerate(lengths):
        tables[b, -(-(int(n) + K - 1) // bs):] = P
    tables[-1, :] = P
    args = [_torch(a) for a in (q, kp, vp, tables, lengths)]
    torch.testing.assert_close(_split_merge(*args, pps),
                               ref.paged_attention_ref(*args),
                               atol=1e-6, rtol=1e-6)


# decode rows, a row count no row tile of the plan divides (16383 x 128),
# a ragged width
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024), (8, 16, 128), (3, 100),
                                   (16383, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(shape, dtype):
    dev = _card()
    x = torch.randn(shape, device=dev).to(TORCH_DT[dtype])
    s = torch.randn(shape[-1], device=dev).to(TORCH_DT[dtype])
    got = rn.rmsnorm(x, s, 1e-6)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [100, 128, 768, 1024, 8192])
@pytest.mark.parametrize("rows", [1, 3, 8, 131, 133, 4099, 16383, 262143])
def test_rmsnorm_plan_covers_every_row_once(rows, d, backward):
    """The program/tile/row map of ``rmsnorm.plan`` (program p takes tiles
    p, p + grid, ...; tile t rows [t * BLOCK_R, (t+1) * BLOCK_R), masked
    past ``rows``) holds every row exactly once; blocks are powers of two,
    BLOCK_D the smallest that holds d, a tile at most
    ``TILE_VALUES`` values unless it is one row; the backward grid at most
    ``BWD_PROGRAMS``, the forward one program per tile."""
    block_r, block_d, warps, grid = rn.plan(rows, d, backward=backward)
    for v in (block_r, block_d, warps):
        assert v >= 1 and v & (v - 1) == 0
    assert block_d >= d > block_d // 2
    assert block_r == 1 or block_r * block_d <= rn.TILE_VALUES
    assert warps <= 32
    tiles = -(-rows // block_r)
    if backward:
        assert 1 <= grid <= min(tiles, rn.BWD_PROGRAMS)
    else:
        assert grid == tiles
    seen = np.zeros(rows, dtype=np.int64)
    for p in range(grid):
        for t in range(p, tiles, grid):
            r = np.arange(t * block_r, (t + 1) * block_r)
            np.add.at(seen, r[r < rows], 1)
    assert (seen == 1).all()


def test_rmsnorm_plan_refuses_empty_and_too_wide_rows():
    with pytest.raises(ValueError, match="rows"):
        rn.plan(0, 128)
    with pytest.raises(ValueError, match="rows"):
        rn.plan(8, rn.MAX_D + 1)
    assert rn.plan(8, rn.MAX_D)[1] == rn.MAX_D


@pytest.mark.cuda
def test_kernel_wrappers_count_only_launches_on_card():
    """A launch adds one to its wrapper's count; an empty x launches
    nothing and counts nothing; a refused head dim counts nothing."""
    dev = _card()
    before = rn.rmsnorm.launches
    y = rn.rmsnorm(torch.empty((0, 128), device=dev),
                   torch.ones(128, device=dev))
    assert y.shape == (0, 128) and rn.rmsnorm.launches == before
    rn.rmsnorm(torch.ones((2, 128), device=dev), torch.ones(128, device=dev))
    assert rn.rmsnorm.launches == before + 1
    before = pa.paged_attention.launches
    q, kp, vp, tables, lengths = _paged_case(2, 4, 4, 32, 4, 3, 1)
    args = [_torch(a).to(dev) for a in (q, kp, vp, tables, lengths)]
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(*args)
    assert pa.paged_attention.launches == before


# ---------------------------------------------------------------------------
# flash attention and the RMSNorm backward (the training slice)
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, D, k_chunk, causal): GQA with S a multiple of the chunk,
# MHA, S = 20 that the requested chunk 8 does not divide (both packages
# then sweep 5-key chunks), and a non-causal GQA case
FLASH_CASES = {"gqa": (2, 24, 4, 2, 16, 8, True),
               "mha": (1, 16, 4, 4, 16, 8, True),
               "ragged": (2, 20, 4, 2, 16, 8, True),
               "full": (1, 16, 4, 2, 16, 8, False)}


def _flash_inputs(B, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_jax_twin_vjp_and_pallas(case):
    """``ops.flash_attention`` on the CPU (the plain versions inside the
    autograd Function) == ``layers.flash_attention_jax`` forward and its
    ``jax.vjp``, and == the Pallas kernel in interpret mode (which takes
    (B, H, S, D)).  f32, 2e-5: the packages sum in different orders."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import layers as jlayers

    B, S, H, Hkv, D, chunk, causal = FLASH_CASES[case]
    q, k, v, do = _flash_inputs(B, S, H, Hkv, D)

    @jax.jit
    def jax_side(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention_jax(
            a, b, c, causal, chunk), q, k, v)
        pallas = jops.flash_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), causal=causal, interpret=True)
        return out, vjp(do), pallas.transpose(0, 2, 1, 3)

    want, want_grads, pallas = jax_side(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal, chunk)
    got.backward(torch.from_numpy(do))
    tol = dict(atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pallas),
                               **tol)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **tol)


def test_flash_attention_fwd_ref_lse_and_bwd_ref_contract():
    """The plain versions' own contract: lse is the log-sum-exp of each
    row's scaled causal scores, and the backward equals autograd of the
    dense attention at f32 (2e-5)."""
    from repro_torch.models.layers import dense_attention

    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(2, 20, 4, 2,
                                                             16, seed=3))
    out, lse = ref.flash_attention_fwd_ref(q, k, v, True, 8)
    scores = torch.einsum("bqhgd,bkhd->bqhgk", q.reshape(2, 20, 2, 2, 16),
                          k) / 4.0
    mask = torch.ones(20, 20, dtype=torch.bool).tril()
    scores = scores.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1).reshape(
        2, 20, 4), atol=2e-5, rtol=2e-5)
    qd, kd, vd = (t.clone().requires_grad_() for t in (q, k, v))
    dense = dense_attention(qd, kd, vd)
    dense.backward(do)
    torch.testing.assert_close(out, dense.detach(), atol=2e-5, rtol=2e-5)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, 8)
    for got, t in zip(grads, (qd, kd, vd)):
        torch.testing.assert_close(got, t.grad, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [128, 1024])
def test_rmsnorm_grads_match_jax(d):
    """``ops.rmsnorm`` differentiated on the CPU (the plain backward inside
    the autograd Function) == ``jax.vjp`` of ``layers.rmsnorm``; f32,
    2e-5 (dscale sums 128 rows)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as jlayers

    rng = np.random.default_rng(d)
    x = rng.standard_normal((8, 16, d)).astype(np.float32)
    s = rng.standard_normal((d,)).astype(np.float32)
    dy = rng.standard_normal((8, 16, d)).astype(np.float32)

    @jax.jit
    def jax_side(x, s, dy):
        y, vjp = jax.vjp(lambda a, b: jlayers.rmsnorm({"scale": b}, a, 1e-6),
                         x, s)
        return y, vjp(dy)

    want, (wdx, wds) = jax_side(*map(jnp.asarray, (x, s, dy)))
    tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, s))
    got = ops.rmsnorm(tx, ts, 1e-6)
    got.backward(torch.from_numpy(dy))
    tol = dict(atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), **tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(wds), **tol)


def test_training_wrappers_refuse_cpu_tensors():
    """The flash and RMSNorm-backward wrappers launch or raise: no
    fallback on a CPU tensor, and nothing counted."""
    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(1, 8, 4, 2, 16))
    lse = torch.zeros(1, 8, 4)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches, rn.rmsnorm_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd(torch.randn(2, 64), torch.randn(64),
                       torch.randn(2, 64))
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            rn.rmsnorm_bwd.launches) == before


# (B, S, H, Hkv, D): the train cell's heads at B = 1, a ragged S, MHA, the
# smoke widths; S one past the bf16 kernels' 128-row tile, a ragged 1000,
# and S = 1, below one tile
CARD_FLASH = [(1, 1024, 16, 8, 128), (2, 200, 16, 8, 128),
              (1, 256, 8, 8, 64), (2, 100, 4, 2, 16), (1, 129, 16, 8, 128),
              (1, 1000, 16, 8, 128), (1, 1, 16, 8, 128)]
# the train step's shape (B = 4, S = 4096), in its dtype only
CARD_FLASH_CASES = [(*shape, dtype) for shape in CARD_FLASH
                    for dtype in ("float32", "bfloat16")]
CARD_FLASH_CASES += [(4, 4096, 16, 8, 128, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,dtype", CARD_FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernels_match_plain_on_card(B, S, H, Hkv, D, causal,
                                                     dtype):
    dev = _card()
    q, k, v, do = (_torch(a, dtype).to(dev)
                   for a in _flash_inputs(B, S, H, Hkv, D))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **tol)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 1000, 16, 8, 128),
                                         (1, 4096, 16, 8, 128)])
def test_flash_attention_bwd_bf16_determinism_on_card(B, S, H, Hkv, D):
    """Two bf16 backward calls on the same inputs: dk and dv bit-identical
    (each written once from registers), dq within tolerance of each other
    (summed into its f32 workspace with atomics, in an order that varies)."""
    dev = _card()
    q, k, v, do = (_torch(a, "bfloat16").to(dev)
                   for a in _flash_inputs(B, S, H, Hkv, D, seed=5))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    dq1, dk1, dv1 = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    dq2, dk2, dv2 = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(dq1.float(), dq2.float(), atol=tol, rtol=tol)


# dscale is a sum over every row, which the kernel and the plain version
# take in different orders, both accumulating in f32 (for either dtype).
# A sequential sum of n terms t_i of random sign rounds each partial sum
# S_k (|S_k| ~ sqrt(k) rms(t)) by up to eps / 2 of itself, an error of
# standard deviation about 0.2 * eps * sqrt(n) * ||t||_2; the difference
# of two such sums has 0.29 of it.  So each column j gets
# atol_j = sqrt(n) * eps_f32 * ||xhat[:, j] * dy[:, j]||_2, 3.5 standard
# deviations of two sequential orders (the blocked and tree orders both
# sides take err far less), beside the element-wise rtol, which also
# covers the bf16 output's own rounding; dx is element-wise and keeps TOL.
DSCALE_ATOL_EPS = float(np.finfo(np.float32).eps)


def _dscale_atol(x, dy, eps=1e-6):
    xf = x.float().reshape(-1, x.shape[-1])
    dyf = dy.float().reshape(-1, x.shape[-1])
    xhat = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    n = xf.shape[0]
    return math.sqrt(n) * DSCALE_ATOL_EPS * (xhat * dyf).norm(dim=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 1024), (512, 16, 128), (3, 100),
                                   (16383, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(shape, dtype):
    dev = _card()
    rng = np.random.default_rng(11)
    x, dy = (_torch(rng.standard_normal(shape).astype(np.float32),
                    dtype).to(dev) for _ in range(2))
    s = _torch(rng.standard_normal(shape[-1]).astype(np.float32),
               dtype).to(dev)
    (dx, ds) = rn.rmsnorm_bwd(x, s, dy, 1e-6)
    (want_dx, want_ds) = ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol,
                               rtol=tol)
    err = (ds.float() - want_ds.float()).abs()
    bound = _dscale_atol(x, dy) + tol * want_ds.float().abs()
    assert bool((err <= bound).all()), (
        f"dscale: max |err| {err.max().item()}, worst err / bound "
        f"{(err / bound).max().item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16384, 1024), (262143, 128)])
def test_rmsnorm_bwd_dscale_bit_identical_on_card(shape):
    """Two backward launches on the same inputs give the same dscale and
    dx, bit for bit: the partial rows are summed in a fixed order, with no
    float atomics."""
    dev = _card()
    rng = np.random.default_rng(12)
    x, dy = (_torch(rng.standard_normal(shape).astype(np.float32),
                    "bfloat16").to(dev) for _ in range(2))
    s = _torch(rng.standard_normal(shape[-1]).astype(np.float32),
               "bfloat16").to(dev)
    first = rn.rmsnorm_bwd(x, s, dy, 1e-6)
    second = rn.rmsnorm_bwd(x, s, dy, 1e-6)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_training_ops_count_one_launch_per_pass_on_card():
    """Forward and backward through ``ops`` launch each kernel once and
    count it once."""
    dev = _card()
    q, k, v, do = (_torch(a, "bfloat16").to(dev).requires_grad_()
                   for a in _flash_inputs(1, 64, 4, 2, 64))
    counts = lambda: (fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches, rn.rmsnorm.launches,
                      rn.rmsnorm_bwd.launches)
    before = counts()
    out = ops.flash_attention(q, k, v)
    y = ops.rmsnorm(out, torch.ones(64, device=dev, dtype=torch.bfloat16,
                                    requires_grad=True))
    y.backward(do.detach())
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1)
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


def _scan_bwd_inputs(shape, seed, device="cpu"):
    """Selective-scan inputs (dt around softplus(-2)), cotangents of y and
    of the final state."""
    B, S, d, N = shape
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)) - 2.0))
    a = -np.tile(np.arange(1, N + 1), (d, 1)) * rng.uniform(0.2, 1.0, (d, 1))
    arrays = (dt, rng.standard_normal((B, S, d)),
              rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
              a, rng.standard_normal((B, S, d)),
              rng.standard_normal((B, d, N)))
    return [_torch(x.astype(np.float32)).to(device) for x in arrays]


def _slstm_bwd_inputs(shape, seed, device="cpu"):
    """sLSTM gx, r_h, the outputs' cotangent and the final state's."""
    B, S, d, H = shape
    dh = d // H
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, S, 4 * d)),
              rng.standard_normal((H, dh, 4 * dh)) / np.sqrt(dh),
              rng.standard_normal((B, S, d)),
              *(rng.standard_normal((B, d)) for _ in range(4)))
    out = [_torch(x.astype(np.float32)).to(device) for x in arrays]
    return out[0], out[1], out[2], tuple(out[3:])


def test_scan_bwd_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The backward kernels' wrappers launch or raise: CPU tensors are
    refused (the CPU takes the plain backwards through ``ops``, which
    count no launch), and a wrong checkpoint shape is refused."""
    dt, xc, bm, cm, a, dy, dh = _scan_bwd_inputs((1, 40, 8, 8), 0)
    before = (ms.mamba_scan_bwd.launches, sl.slstm_scan_bwd.launches,
              ms.mamba_scan.launches, sl.slstm_scan.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan_bwd(dt, xc, bm, cm, a,
                          torch.empty(ms.ckpt_shape(dt, a)), dy, dh)
    assert ms.ckpt_shape(dt, a) == (1, 2, 8, 8)
    gx, r_h, dout, dfin = _slstm_bwd_inputs((1, 5, 8, 2), 1)
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm_scan_bwd(r_h, dout, sl.residuals(gx), dout, dfin)
    leaves = [t.clone().requires_grad_() for t in (dt, xc, bm, cm, a)]
    y, h = ops.mamba_scan(*leaves)
    (y.sum() + h.sum()).backward()
    g, r = gx.clone().requires_grad_(), r_h.clone().requires_grad_()
    out, state = ops.slstm_scan(g, r)
    (out.sum() + sum(s.sum() for s in state)).backward()
    assert all(t.grad is not None for t in (*leaves, g, r))
    assert (ms.mamba_scan_bwd.launches, sl.slstm_scan_bwd.launches,
            ms.mamba_scan.launches, sl.slstm_scan.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 1000, 8), (1, 70, 256, 16),
                                   (1, 45, 200, 8)])
def test_mamba_scan_bwd_kernel_matches_plain_on_card(shape):
    """The backward kernel (from the forward's tile checkpoints) against
    the plain backward, nonzero dh_last, f32: every gradient within 1e-4
    of its largest entry; two calls give equal bits."""
    dev = _card()
    dt, xc, bm, cm, a, dy, dh = _scan_bwd_inputs(shape, 7, dev)
    h_ckpt = torch.empty(ms.ckpt_shape(dt, a), device=dev)
    ms.mamba_scan(dt, xc, bm, cm, a, h_ckpt=h_ckpt)
    got = ms.mamba_scan_bwd(dt, xc, bm, cm, a, h_ckpt, dy, dh)
    again = ms.mamba_scan_bwd(dt, xc, bm, cm, a, h_ckpt, dy, dh)
    want = ref.mamba_scan_bwd_ref(dt, xc, bm, cm, a, dy, dh)
    torch.cuda.synchronize()
    for g, b, w in zip(got, again, want):
        assert torch.equal(g, b)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 392, 2), (1, 50, 768, 4),
                                   (1, 20, 128, 2), (1, 20, 200, 2),
                                   (1, 20, 450, 2)])
def test_slstm_scan_bwd_kernel_matches_plain_on_card(shape):
    """The backward kernel (from the forward's saved gates and states)
    against the plain backward with nonzero final-state cotangents, f32:
    d_gx and d_r_h within 1e-4 of their largest entry; equal bits twice.
    The heads reach every layout the kernel is built for (``bwd_plan``):
    dh = 196 (16 lanes a row), 192 (8 lanes, 192 threads), 64 (4 lanes,
    64 weights), 100 (8 lanes, 400 threads) and 225 (a 16-block cluster
    whose last block owns no channel)."""
    dev = _card()
    gx, r_h, dy, dfin = _slstm_bwd_inputs(shape, 8, dev)
    saved = sl.residuals(gx)
    out, _ = sl.slstm_scan(gx, r_h, saved)
    got = sl.slstm_scan_bwd(r_h, out, saved, dy, dfin)
    again = sl.slstm_scan_bwd(r_h, out, saved, dy, dfin)
    want = ref.slstm_bwd_ref(gx, r_h, dy, dfin)
    torch.cuda.synchronize()
    for g, b, w in zip(got, again, want):
        assert torch.equal(g, b)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def _slstm_tie_inputs(shape, seed, device="cpu"):
    """sLSTM backward inputs at exact ties of the stabiliser's max from the
    second step on (the i gate 0.5, the f gate 100, r_h's i and f columns
    zero: lf + m_{t-1} == i), with nonzero final-state cotangents, through
    which the tied max's 1/2 : 1/2 share reaches d_gx."""
    gx, r_h, dy, dfin = _slstm_bwd_inputs(shape, seed)
    d, dh = shape[2], shape[2] // shape[3]
    gx[..., :d], gx[..., d:2 * d] = 0.5, 100.0
    r_h[..., :2 * dh] = 0.0
    return (gx.to(device), r_h.to(device), dy.to(device),
            tuple(t.to(device) for t in dfin))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 768, 4), (1, 33, 96, 2)])
def test_slstm_scan_bwd_kernel_at_exact_ties_on_card(shape):
    """At exact ties of ``max(lf + m, i)`` the backward kernel (factors
    computed ahead of the sweep from the forward's saved values) takes
    JAX's 1/2 : 1/2 share as the plain backward does: d_gx and d_r_h
    within 1e-4 of their largest entry, equal bits twice."""
    dev = _card()
    gx, r_h, dy, dfin = _slstm_tie_inputs(shape, 9, dev)
    saved = sl.residuals(gx)
    out, _ = sl.slstm_scan(gx, r_h, saved)
    lf = torch.nn.functional.logsigmoid(saved[0][:, 1:, shape[2]:2 * shape[2]])
    assert torch.equal(lf + saved[3][:, :-1], saved[0][:, 1:, :shape[2]])
    got = sl.slstm_scan_bwd(r_h, out, saved, dy, dfin)
    again = sl.slstm_scan_bwd(r_h, out, saved, dy, dfin)
    want = ref.slstm_bwd_ref(gx, r_h, dy, dfin)
    torch.cuda.synchronize()
    for g, b, w in zip(got, again, want):
        assert torch.equal(g, b)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("dh", [16, 32, 48, 78, 110, 156, 192, 196, 221, 225,
                                256, 307])
def test_slstm_bwd_plan_holds_every_r_h_entry_once(dh):
    """The backward's slice layout (``bwd_plan``: block c, row r, slice s,
    weight i = 4 m + g holds ``r_h[head][c * cb + r][g * dh + m * ks +
    s]``) holds every entry of a head's r_h exactly once, within 448
    threads a block and ``BWD_KMAX`` weights a lane (the fewest lanes a
    row that allow that); a row's slices are adjacent lanes of one warp
    (ks divides 32), and a row has a lane for every block to send to."""
    C, cb, ks, kl = sl.bwd_plan(dh)
    assert (C, cb) == sl.cluster_plan(dh)
    assert ks in sl.BWD_SLICES and 32 % ks == 0 and kl % 4 == 0
    assert -(-cb * ks // 32) * 32 <= sl.BWD_THREADS and kl <= sl.BWD_KMAX
    assert ks == sl.BWD_SLICES[0] or 4 * -(-dh // (ks // 2)) > sl.BWD_KMAX
    assert C <= ks
    held = np.zeros((dh, 4 * dh), dtype=np.int64)
    for c in range(C):
        for r in range(cb):
            if c * cb + r >= dh:
                continue
            for s in range(ks):
                for i in range(kl):
                    jj = (i // 4) * ks + s
                    if jj < dh:
                        held[c * cb + r, (i % 4) * dh + jj] += 1
    assert (held == 1).all()


def test_slstm_bwd_plan_refuses_head_past_max_before_device():
    """A head past ``MAX_HEAD_DIM`` is refused by the plan and by the
    backward's wrapper before its device check, with no launch counted."""
    dh = sl.MAX_HEAD_DIM + 1
    with pytest.raises(ValueError, match="head dim"):
        sl.bwd_plan(dh)
    gx = torch.zeros((1, 2, 4 * dh))
    z = torch.zeros((1, 2, dh))
    before = sl.slstm_scan_bwd.launches
    with pytest.raises(ValueError, match=f"at most {sl.MAX_HEAD_DIM}"):
        sl.slstm_scan_bwd(torch.zeros((1, dh, 4 * dh)), z,
                          (gx, z, z, z), z, (z[:, 0],) * 4)
    assert sl.slstm_scan_bwd.launches == before


@pytest.mark.parametrize("S", [1, 7, 8, 9, 32, 33, 45, 77, 100, 4096])
def test_mamba_bwd_sweep_covers_every_step_once(S):
    """The backward's walk (``bwd_sweep``): every step of [0, S) once, in
    descending order, a tile's sub-tiles of ``SUB`` steps last first, at
    most ``TILE / SUB`` of them a tile."""
    order = ms.bwd_sweep(S)
    assert [t for _, _, steps in order for t in steps] == \
        list(range(S - 1, -1, -1))
    for k, u, steps in order:
        assert 0 <= u < ms.TILE // ms.SUB and steps
        assert all(k * ms.TILE + u * ms.SUB <= t < k * ms.TILE + (u + 1)
                   * ms.SUB for t in steps)


@pytest.mark.parametrize("N", [8, 16])
def test_mamba_bwd_sum_lanes_store_every_sum_once(N):
    """After the backward's reduce-scatter over a warp's channel groups
    the storing lanes (``bwd_sum_lane``) hold every one of the warp's 2N
    per-step sums of d_B and d_C exactly once."""
    held = [ms.bwd_sum_lane(lane, N) for lane in range(32)]
    stored = sorted(h for h in held if h is not None)
    assert stored == sorted((w, n) for w in "bc" for n in range(N))
    assert sum(h is None for h in held) == 32 - 2 * N


def test_count_launch_loses_no_launch_across_threads():
    """Wrappers count launches from the tournament's worker threads: 16
    threads x 2,000 counts under a short switch interval lose none."""
    import sys
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000


@pytest.mark.cuda
def test_population_lm_step_equals_in_place_step_on_card():
    """The LM tournament's functional step (weights bound to a weight-less
    module, new tensors returned) and the train CLI's in-place step give
    the same weights, moments and losses bit for bit on the card, in f32
    (the f32 flash backward sums dQ without atomics), through the same
    kernels: each step launches the flash and RMSNorm kernels alike."""
    import dataclasses

    from repro_torch.configs import qwen3_06b
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import train_batch
    from repro_torch.train import steps

    dev = _card()
    cfg = dataclasses.replace(qwen3_06b.SMOKE, dtype="float32",
                              attn_impl="chunked", attn_chunk=8)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=1)
    init, step, _, _, _ = steps.make_lm_population_fns(cfg, opt, device=dev)
    params, opt_state, h = init(0)
    state = steps.init_lm_state(cfg, opt, seed=0, device=dev)
    in_place = steps.make_lm_train_step(cfg, opt)
    counts = lambda: (fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches, rn.rmsnorm.launches,
                      rn.rmsnorm_bwd.launches)
    for i in range(3):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(dev)
                 for k, v in train_batch(cfg, 2, 24, seed=i).items()}
        before = {n: t.clone() for n, t in params.items()}
        c0 = counts()
        params_new, opt_state, m = step(params, opt_state, batch, h)
        c1 = counts()
        state, m2 = in_place(state, batch)
        c2 = counts()
        assert all(torch.equal(params[n], before[n]) for n in params)
        params = params_new
        assert torch.equal(m["loss"], m2["loss"])
        per_step = tuple(b - a for a, b in zip(c0, c1))
        assert per_step == tuple(b - a for a, b in zip(c1, c2))
        assert all(per_step)
    for n, t in state["model"].named_parameters():
        assert torch.equal(params[n], t), n
        assert torch.equal(opt_state["m"][n], state["opt_state"]["m"][n])


# ---------------------------------------------------------------------------
# the selective scan and the sLSTM (the recurrent serving slice)
# ---------------------------------------------------------------------------


def _mamba_inputs(B, S, d, N, seed=0):
    """The distributions of the JAX package's test (``test_kernels.py``):
    small positive dt, unit xc, B/C at 0.5, A = -exp(N(0, 0.3^2))."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)))) * 0.1
    xc = rng.standard_normal((B, S, d))
    bm = rng.standard_normal((B, S, N)) * 0.5
    cm = rng.standard_normal((B, S, N)) * 0.5
    a = -np.exp(rng.standard_normal((d, N)) * 0.3)
    return [x.astype(np.float32) for x in (dt, xc, bm, cm, a)]


def _slstm_inputs(B, S, d, H, seed=0):
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((B, S, 4 * d)).astype(np.float32)
    r = (rng.standard_normal((H, d // H, 4 * d // H))
         / np.sqrt(d)).astype(np.float32)
    return gx, r


@pytest.mark.parametrize("B,S,d,N,bd,ck", [
    (2, 64, 32, 8, 16, 32),
    (1, 96, 48, 16, 48, 24),
    (2, 128, 64, 16, 32, 64),
])
def test_mamba_scan_ref_matches_pallas_oracle_and_stepped_state(B, S, d, N,
                                                                bd, ck):
    """The plain version's ``y`` == the Pallas kernel (interpret) and
    ``ref.mamba_scan_ref`` at the JAX test's shapes, within its 1e-4.  Its
    final state == the JAX oracle's state after S steps, read out through
    the oracle itself: with C_t = e_n every step, ``y[S-1]`` is
    ``h[:, n]``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import mamba_scan as jms
    from repro.kernels import ref as jref

    dt, xc, bm, cm, a = _mamba_inputs(B, S, d, N)

    @jax.jit
    def jax_side(dt, xc, bm, cm, a):
        pallas = jms.mamba_scan(dt, xc, bm, cm, a, block_d=bd, chunk=ck,
                                interpret=True)
        onehot = jnp.broadcast_to(jnp.eye(N)[:, None, None, :],
                                  (N, B, S, N))
        h = jax.vmap(lambda c: jref.mamba_scan_ref(dt, xc, bm, c, a)[:, -1]
                     )(onehot)                               # (N, B, d)
        return pallas, jref.mamba_scan_ref(dt, xc, bm, cm, a), \
            h.transpose(1, 2, 0)

    pallas, want, want_h = jax_side(*map(jnp.asarray, (dt, xc, bm, cm, a)))
    y, h = ref.mamba_scan_ref(*map(torch.from_numpy, (dt, xc, bm, cm, a)))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **tol)


@pytest.mark.parametrize("B,S,d,H,bb,ck", [
    (2, 40, 64, 4, 2, 8),
    (4, 64, 128, 4, 4, 64),
    (3, 33, 96, 2, 1, 11),
])
def test_slstm_ref_matches_pallas_oracle_and_stepped_cell(B, S, d, H, bb, ck):
    """The plain version's ``h`` == the Pallas kernel (interpret) and
    ``ref.slstm_ref`` at the JAX test's shapes, within its 1e-5; its final
    ``(h, c, n, m)`` == ``xlstm._slstm_cell`` stepped over the S steps."""
    jax = pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp
    from repro.configs.base import ModelConfig
    from repro.kernels import ref as jref
    from repro.kernels import slstm as jsl
    from repro.models import xlstm as jx

    gx, r = _slstm_inputs(B, S, d, H)
    cfg = dataclasses.replace(ModelConfig(), d_model=d, num_heads=H)

    @jax.jit
    def jax_side(gx, r):
        state, _ = jx.init_slstm_state(cfg, B)
        final, _ = jax.lax.scan(
            lambda st, g: (jx._slstm_cell({"r_h": r}, cfg, st, g)[1], None),
            state, gx.swapaxes(0, 1))
        return (jsl.slstm_scan(gx, r, block_b=bb, chunk=ck, interpret=True),
                jref.slstm_ref(gx, r, H), final)

    pallas, want, final = jax_side(jnp.asarray(gx), jnp.asarray(r))
    h, state = ref.slstm_ref(torch.from_numpy(gx), torch.from_numpy(r))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(pallas), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), **tol)
    for got, k in zip(state, "hcnm"):
        np.testing.assert_allclose(got.numpy(), np.asarray(final[k]),
                                   err_msg=k, **tol)


def test_scan_dispatch_takes_plain_version_on_cpu_and_wrappers_refuse_it():
    """On CPU tensors ``ops`` runs the plain scans and launches nothing;
    the kernel wrappers themselves raise on them, counting nothing."""
    mam = [torch.from_numpy(x) for x in _mamba_inputs(1, 9, 16, 8)]
    gx, r = (torch.from_numpy(x) for x in _slstm_inputs(2, 5, 32, 2))
    before = (ms.mamba_scan.launches, sl.slstm_scan.launches)
    for got, want in ((ops.mamba_scan(*mam), ref.mamba_scan_ref(*mam)),
                      (ops.slstm_scan(gx, r), ref.slstm_ref(gx, r))):
        torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan(*mam)
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm_scan(gx, r)
    assert (ms.mamba_scan.launches, sl.slstm_scan.launches) == before


@pytest.mark.parametrize("dh", [32, 48, 192, 225, 256])
def test_slstm_cluster_plan_owns_every_channel_once(dh):
    """The blocks of the cluster own runs of the head's channels, together
    every channel once; a block's r_h slice fits in 227 KB; at most 16
    blocks."""
    C, cb = sl.cluster_plan(dh)
    assert C in sl.CLUSTER_SIZES and C <= 16
    owned = [ch for c in range(C) for ch in range(c * cb, min((c + 1) * cb,
                                                               dh))]
    assert sorted(owned) == list(range(dh))
    assert sl.slice_bytes(dh, cb) <= min(sl.SLICE_BYTES, 227 * 1024)
    if C > 1:       # the smallest cluster that fits
        half = -(-dh // (C // 2))
        assert sl.slice_bytes(dh, half) > sl.SLICE_BYTES


def test_slstm_wrapper_refuses_head_past_max_before_device():
    """A head one channel past ``MAX_HEAD_DIM`` (the widest a 16-block
    cluster holds) raises from the shape check, before the device check,
    and counts no launch; the plan takes ``MAX_HEAD_DIM`` itself."""
    dh = sl.MAX_HEAD_DIM + 1
    gx = torch.zeros((1, 2, 4 * dh))
    r_h = torch.zeros((1, dh, 4 * dh))
    before = sl.slstm_scan.launches
    with pytest.raises(ValueError, match=f"at most {sl.MAX_HEAD_DIM}"):
        sl.slstm_scan(gx, r_h)
    with pytest.raises(ValueError, match="head dim"):
        sl.cluster_plan(dh)
    assert sl.slstm_scan.launches == before
    assert sl.cluster_plan(sl.MAX_HEAD_DIM)[0] == 16


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("d", [128, 1000, 4096, 16384])
def test_mamba_scan_plan_owns_every_channel_state_once(d, N):
    """The kernel's thread map under ``scan_plan`` (block i owns channels
    [i * CH, (i+1) * CH); thread x the K = ``CHANNELS_PER_THREAD``
    channels from ``x // L * K`` of its block and, of each, the states
    [(x % L) * N/L, (x % L + 1) * N/L), masked past d) holds every
    (channel, state) pair exactly once; CH / K * L is the block's threads
    and CH a multiple of 4 (16-byte rows)."""
    L, CH = ms.scan_plan(d, N)
    K = ms.CHANNELS_PER_THREAD
    assert L == ms.LANES and N % L == 0
    assert CH // K * L == ms.THREADS and CH % 4 == 0
    seen = np.zeros((d, N), dtype=np.int64)
    nl = N // L
    for blk in range(-(-d // CH)):
        for x in range(ms.THREADS):
            for q in range(K):
                ch = blk * CH + x // L * K + q
                if ch < d:
                    seen[ch, (x % L) * nl:(x % L + 1) * nl] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("N", [1, 4, 12, 32])
def test_mamba_scan_plan_refuses_other_state_sizes(N):
    with pytest.raises(ValueError, match="N="):
        ms.scan_plan(1024, N)


# mamba: (B, S, d_in, N) — jamba's serve shape, a ragged S, B = 2, the
# smoke widths, S = 1, a d_in no channel block of the plan divides and one
# that is not a multiple of 4 (4-byte copies); sLSTM: (B, S, d, H) — xlstm-125m (a cluster of 8), the JAX
# test's ragged one, the smoke widths, dh = 196 over a cluster of 8 (25
# channels a block, the last block's tail masked) and dh = 225 over 16
# (15 a block, the last block owning none)
CARD_MAMBA = [(1, 500, 16384, 16), (1, 37, 16384, 16), (2, 200, 4096, 16),
              (2, 20, 128, 8), (1, 1, 4096, 16), (2, 40, 1000, 8),
              (2, 33, 130, 16)]
CARD_SLSTM = [(1, 500, 768, 4), (3, 33, 96, 2), (2, 20, 64, 2),
              (2, 40, 392, 2), (1, 20, 450, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,N", CARD_MAMBA)
def test_mamba_scan_kernel_matches_plain_on_card(B, S, d, N):
    """y and the final state within |err| <= 1e-4 + 1e-4 |want| (f32, S
    sequential steps), and one launch counted."""
    dev = _card()
    args = [torch.from_numpy(x).to(dev) for x in _mamba_inputs(B, S, d, N)]
    before = ms.mamba_scan.launches
    got = ms.mamba_scan(*args)
    want = ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,H", CARD_SLSTM)
def test_slstm_kernel_matches_plain_on_card(B, S, d, H):
    """h and the final (h, c, n, m) within 1e-4 + 1e-4 |want| (f32), and
    one launch counted."""
    dev = _card()
    gx, r = (torch.from_numpy(x).to(dev) for x in _slstm_inputs(B, S, d, H))
    before = sl.slstm_scan.launches
    h, state = sl.slstm_scan(gx, r)
    want_h, want_state = ref.slstm_ref(gx, r)
    torch.cuda.synchronize()
    assert sl.slstm_scan.launches == before + 1
    for g, w in zip((h, *state), (want_h, *want_state)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
