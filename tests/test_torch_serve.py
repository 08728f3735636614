"""The port's scheduler against the JAX scheduler on the same trace (CPU).

Both packages serve the qwen3 smoke config at f32 with the same weights
(carried across by ``repro_torch.bridge``) through 2 slots and 4-token
pages; the trace mixes prompt lengths 5-24 and shares prompt prefixes.
Generated tokens must be identical, as must the pool's block and
prefix-sharing counters and the scheduler's step counters.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "ragged_splits")


def _trace(vocab: int, temperature: float):
    """Six requests, prompts 5..24 tokens; request 1 reuses the first
    pages of request 0 while it is live (prefix sharing); requests 2 and
    3 (24 and 5 tokens) decode side by side, which triggers the CPU
    path's ragged width split."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 24).astype(np.int32)

    def fresh(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    prompts = [base[:13], np.concatenate([base[:12], fresh(6)]), fresh(24),
               fresh(5), fresh(9), np.concatenate([base[:8], fresh(3)])]
    return [dict(rid=i, prompt=p, max_new=6, temperature=temperature,
                 seed=None if temperature <= 0 else 100 + i)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def weights():
    jax = pytest.importorskip("jax")
    from repro.configs import qwen3_06b as jq
    from repro.models.lm import init_lm as jax_init_lm
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.models.lm import init_lm

    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    tcfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    # initialised under jit: one compile instead of one dispatch per op
    params = jax.jit(lambda key: jax_init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = init_lm(tcfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("temperature,chunk,policy,pin", [
    (0.0, 0, "continuous", False),
    (0.8, 0, "continuous", False),
    (0.0, 4, "continuous", False),
    (0.8, 4, "static", False),
    (0.0, 0, "continuous", True),
])
def test_scheduler_token_identity_with_jax(weights, temperature, chunk,
                                           policy, pin):
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, tcfg, model = weights
    kw = dict(num_slots=2, max_len=30, block_size=4, prefill_chunk=chunk,
              policy=policy, pin_prefix=pin)
    js = JScheduler(jcfg, params, telemetry=False, **kw)
    ts = Scheduler(tcfg, model, device="cpu", **kw)
    for r in _trace(jcfg.vocab_size, temperature):
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    jres, tres = js.run(max_steps=400), ts.run(max_steps=400)
    assert sorted(tres) == sorted(jres) == list(range(6))
    for rid in jres:
        assert tres[rid].tolist() == jres[rid].tolist(), rid
    assert ts.pool.as_dict() == js.pool.as_dict()
    jd, td = js.stats.as_dict(), ts.stats.as_dict()
    for k in STEP_COUNTERS:
        assert td[k] == jd[k], k
    if policy == "continuous":
        # static admits a whole batch before any prompt is prefilled, so
        # only the continuous trace shares prefixes and splits widths
        assert ts.pool.prefix_hits >= 1
        assert td["ragged_splits"] > 0
    if pin:
        assert ts.pool.as_dict()["pinned_blocks"] > 0


def test_cli_serves_smoke_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--requests", "4",
         "--max-new", "5", "--out-json", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] throughput" in proc.stdout
    payload = json.loads(out.read_text())
    assert payload["stats"]["completed"] == 4
    assert payload["device"] == "cpu"
    assert sorted(payload["results"]) == ["0", "1", "2", "3"]
    assert all(len(v) == 5 for v in payload["results"].values())


@pytest.mark.cuda
def test_scheduler_on_card_matches_cpu():
    """The smoke trace served on the card (CUDA and Triton kernels) gives
    the CPU path's tokens at f32, and both kernels were launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Request, Scheduler

    cfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    cpu_model = init_lm(cfg, device="cpu")
    results = {}
    for device in ("cpu", "cuda"):
        model = init_lm(cfg, device=device)
        model.load_state_dict(cpu_model.state_dict())
        s = Scheduler(cfg, model, num_slots=2, max_len=30, block_size=4,
                      device=device)
        for r in _trace(cfg.vocab_size, 0.0):
            s.submit(Request(**r))
        before = (pa.paged_attention.launches, rn.rmsnorm.launches)
        results[device] = {k: v.tolist() for k, v in s.run().items()}
    assert results["cuda"] == results["cpu"]
    assert pa.paged_attention.launches > before[0]
    assert rn.rmsnorm.launches > before[1]
