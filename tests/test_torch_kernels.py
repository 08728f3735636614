"""The port's kernels: plain versions against the JAX oracles on the CPU,
the kernels themselves against the plain versions on a CUDA card.

On the CPU, ``repro_torch.kernels.ref`` is held against
``repro.kernels.ref`` and against the Pallas kernels run in interpret
mode, on the same numpy inputs.  Tolerances: f32 2e-5; bf16 2e-2,
compared in f32 (as ``tests/test_paged.py`` states them).  The CUDA and
Triton kernels have no CPU mode: their tests carry the ``cuda`` marker
and skip without a card (run them on one with
``python -m pytest -m cuda tests/test_torch_kernels.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn

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
