"""The port's surrogate engine against the JAX package's on the CPU.

The SMOKE CycleGAN in f32: JAX weights cross through
``repro_torch.bridge``, queries are made with numpy from a seed, and both
engines serve them with the same ``max_batch`` and ``bucket``.  Results
agree to 1e-5 relative (f32 MLPs summing in different orders); the
pipeline counters agree exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("completed", "prefills", "prefill_tokens",
            "padded_prefill_tokens", "decode_steps", "decode_slot_steps",
            "hot_swaps", "rejected")


@pytest.fixture(scope="module")
def weights():
    """Two JAX SMOKE weight sets and the port's bridged copies."""
    jax = pytest.importorskip("jax")
    from repro.configs import icf_cyclegan as jcfgs
    from repro.models import icf_cyclegan as jcg
    from repro_torch import bridge

    jp = [jcg.init_cyclegan(jcfgs.SMOKE, jax.random.PRNGKey(s))[0]
          for s in (0, 7)]
    tp = [bridge.cyclegan_params_from_jax(jax.tree.map(np.asarray, p))
          for p in jp]
    return jp, tp


class _ArmedRegistry:
    """refresh() reports a new winner exactly once, when armed (the
    JAX package's test double)."""

    def __init__(self):
        self.params = None
        self.armed = None

    def refresh(self):
        if self.armed is not None:
            self.params, self.armed = self.armed, None
            return True
        return False


def _queries(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {i: rng.normal(size=(n, 5)).astype(np.float32)
            for i, n in enumerate(rows)}


def _engines(weights, **kw):
    from repro.configs import icf_cyclegan as jcfgs
    from repro.serve.surrogate import SurrogateEngine as JEngine
    from repro_torch.configs import icf_cyclegan as tcfgs
    from repro_torch.serve.surrogate import SurrogateEngine

    jp, tp = weights
    jeng = JEngine(jcfgs.SMOKE, jp[0], telemetry=False, **kw)
    teng = SurrogateEngine(tcfgs.SMOKE, tp[0], device="cpu", **kw)
    return jeng, teng


def _predict(weights, i, x):
    from repro_torch.models import icf_cyclegan as tcg

    with torch.no_grad():
        return tcg.predict(weights[1][i]["gen"], torch.from_numpy(x)).numpy()


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,max_batch,bucket", [
    ([3, 4, 5, 6], 16, 4),
    ([6] * 5, 8, 4),
    ([20, 3, 2, 8, 1], 8, 4),           # the 20-row head query: alone
])
def test_engine_matches_jax(weights, rows, max_batch, bucket):
    jeng, teng = _engines(weights, max_batch=max_batch, bucket=bucket)
    qs = _queries(rows)
    for i, x in qs.items():
        jeng.submit(i, x)
        teng.submit(i, x)
    jres, tres = jeng.run(max_steps=50), teng.run(max_steps=50)
    assert sorted(tres) == sorted(jres) == list(qs)
    for i, x in qs.items():
        assert tres[i].shape == (len(x), teng.cfg.output_dim)
        _close(tres[i], np.asarray(jres[i]))
        _close(tres[i], _predict(weights, 0, x))
    jd, td = jeng.stats.as_dict(), teng.stats.as_dict()
    for k in COUNTERS:
        assert td[k] == jd[k], k
    assert teng.overlapped_stages == jeng.overlapped_stages
    if rows[0] > max_batch:
        # the oversized head went alone, padded to its bucket
        assert td["padded_prefill_tokens"] >= 20 + 4 - 20 % 4


def test_wrong_width_raises_and_counts_as_rejected(weights):
    jeng, teng = _engines(weights, max_batch=8, bucket=4)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match=r"expected \(n, 5\)"):
            eng.submit("bad", np.zeros((2, 4), np.float32))
        eng.submit("ok", np.zeros((2, 5), np.float32))
        assert eng.stats.rejected == 1 and eng.stats.submitted == 1
        assert list(eng.run()) == ["ok"]


def test_hot_swap_lands_after_watch_every_steps(weights):
    """The registry is polled every 2 steps; the swap found at step 2
    serves every batch dispatched from then on, in both packages."""
    jp, tp = weights
    regs = [_ArmedRegistry(), _ArmedRegistry()]
    jeng, teng = _engines(weights, max_batch=8, bucket=4)
    jeng.registry, teng.registry = regs
    jeng.watch_every = teng.watch_every = 2
    regs[0].armed, regs[1].armed = jp[1], tp[1]
    qs = _queries([6] * 5, seed=3)
    for i, x in qs.items():
        jeng.submit(i, x)
        teng.submit(i, x)
    jres, tres = jeng.run(), teng.run()
    assert jeng.stats.hot_swaps == teng.stats.hot_swaps == 1
    # step 1 dispatched query 0 on the first weights; step 2 swapped
    assert teng.served_by == {0: 0, 1: 1, 2: 1, 3: 1, 4: 1}
    for i, x in qs.items():
        _close(tres[i], np.asarray(jres[i]))
        _close(tres[i], _predict(weights, teng.served_by[i], x))
    assert not np.allclose(tres[0], _predict(weights, 1, qs[0]))


def test_serve_cli_surrogate_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "icf-cyclegan", "--smoke", "--device", "cpu", "--queries", "8"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    for tag in ("workload=surrogate", "device=cpu", "queries=8",
                "[serve] requests: submitted=8 completed=8",
                "[serve] throughput", "[serve] surrogate: rows=64"):
        assert tag in out, tag
    mean = float(out.split("output_mean=")[1].split()[0])
    assert np.isfinite(mean)


@pytest.mark.cuda
def test_pinned_streamed_path_on_card_matches_plain_predict():
    """On the card the engine uploads from pinned memory on its own
    stream and copies results into pinned buffers; every row agrees with
    a plain ``predict`` on the same card (1e-5 relative: the engine's
    padded batches may take other matmul tilings), and a hot swap
    lands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import icf_cyclegan as tcfgs
    from repro_torch.models import icf_cyclegan as tcg
    from repro_torch.serve.surrogate import SurrogateEngine

    p = [tcg.init_cyclegan(tcfgs.SMOKE, s, "cuda") for s in (0, 1)]
    reg = _ArmedRegistry()
    eng = SurrogateEngine(tcfgs.SMOKE, p[0], max_batch=16, bucket=8,
                          registry=reg, watch_every=3, device="cuda")
    reg.armed = p[1]
    qs = _queries([8, 8, 5, 20, 8, 8, 8, 3], seed=5)
    for i, x in qs.items():
        eng.submit(i, x)
    res = eng.run()
    assert eng.stats.hot_swaps == 1 and eng.overlapped_stages > 0
    assert set(eng.served_by.values()) == {0, 1}
    with torch.no_grad():
        for i, x in qs.items():
            want = tcg.predict(p[eng.served_by[i]]["gen"],
                               torch.from_numpy(x).cuda()).cpu().numpy()
            _close(res[i], want)
