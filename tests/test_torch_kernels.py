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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024), (8, 16, 128), (3, 100)])
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
@pytest.mark.parametrize("shape", [(4096, 1024), (512, 16, 128), (3, 100)])
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


# mamba: (B, S, d_in, N) — jamba's serve shape, a ragged S, B = 2, the
# smoke widths; sLSTM: (B, S, d, H) — xlstm-125m, the JAX test's ragged one
CARD_MAMBA = [(1, 500, 16384, 16), (1, 37, 16384, 16), (2, 200, 4096, 16),
              (2, 20, 128, 8)]
CARD_SLSTM = [(1, 500, 768, 4), (3, 33, 96, 2), (2, 20, 64, 2)]


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
