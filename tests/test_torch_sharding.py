"""The port's logical sharding rules and tensor-parallel cut of the LMs
against the JAX package (CPU, one process).

``repro_torch.parallel.sharding.resolve`` is held to JAX's
``ShardingRules.resolve`` for every qwen3 parameter (SMOKE and FULL, from
JAX's ``launch.specs.param_specs``: the leaves are stacked over the
layer period, so the leading axis is dropped and the dense weights are
transposed to the port's ``nn.Linear`` layout) on seven meshes, under
``DEFAULT_RULES``, ``SERVE_RULES`` and the serving mesh's rule set, and on
shapes that do not divide.  JAX's ``resolve`` reads a mesh's
``axis_names`` and ``shape`` only, so a stand-in needs no devices.  The
shards ``shard_lm`` cuts equal the slices of the bridged JAX weights,
the replicated-attention case included.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.parallel import sharding as jshard
from repro.serve import mesh as jmesh
from repro_torch import bridge
from repro_torch.configs.base import replace
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as tshard
from repro_torch.parallel import tensor as ttensor

MESHES = {"1x1": {"data": 1, "model": 1}, "2x1": {"data": 2, "model": 1},
          "1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
          "pod2x2x2": {"pod": 2, "data": 2, "model": 2}}
RULES = {"default": ({}, {}),
         "serve": (jshard.SERVE_RULES, tshard.SERVE_RULES),
         "mesh_serve": (jmesh.MESH_SERVE_RULES, tshard.MESH_SERVE_RULES)}


def _jax_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _jax_resolve(axes, sizes, rules, shape=None):
    return tuple(jshard.ShardingRules(_jax_mesh(sizes), dict(rules))
                 .resolve(axes, shape))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)) and not _is_axes(tree):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _is_axes(t):
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


@functools.lru_cache(maxsize=None)
def _qwen3_leaves(smoke):
    """(port name of layer 0 / top-level, JAX axes without the stacking
    axis, JAX shape without it, transposed?) of every JAX leaf of qwen3."""
    cfg = jax_get_config("qwen3-0.6b", smoke=smoke)
    shapes, axes = jspecs.param_specs(cfg)
    shapes = dict(_flat(shapes))
    out = []
    for path, ax in _flat(axes):
        shape = tuple(shapes[path].shape)
        if path.startswith("body."):
            # body.<j>.<leaf path>: the period stack (qwen3: R = 1)
            _, j, rest = path.split(".", 2)
            assert ax[0] == "period" and j == "0"
            ax, shape = ax[1:], shape[1:]
            name, transposed = bridge._port_name(rest)
            name = f"blocks.0.{name}"
        else:
            name, transposed = bridge._port_name(path)
        out.append((name, ax, shape, transposed))
    return tuple(out)


def test_rule_sets_equal_jax():
    assert tshard.DEFAULT_RULES == jshard.DEFAULT_RULES
    assert tshard.SERVE_RULES == jshard.SERVE_RULES
    assert tshard.MESH_SERVE_RULES == jmesh.MESH_SERVE_RULES
    assert tshard.serve_rules(kv_seq=None, mlp="data") == \
        jshard.serve_rules(kv_seq=None, mlp="data")
    assert tshard.seq_parallel_rules() == jshard.seq_parallel_rules()


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_resolve_equals_jax_for_every_qwen3_parameter(smoke, mesh, rules):
    sizes = MESHES[mesh]
    jrules, trules = RULES[rules]
    tcfg = get_config("qwen3-0.6b", smoke=smoke)
    taxes = tshard.param_axes(tcfg)
    leaves = _qwen3_leaves(smoke)
    assert len(leaves) == 13
    for name, ax, shape, transposed in leaves:
        order = slice(None, None, -1) if transposed else slice(None)
        assert taxes[name] == tuple(ax)[order], name
        want = _jax_resolve(ax, sizes, jrules, shape)
        got = tshard.resolve(taxes[name], sizes, trules, shape[order])
        assert got == want[order], name
        # without a shape (no divisibility check), and the dict vs a
        # stand-in mesh object
        assert tshard.resolve(taxes[name], _jax_mesh(sizes), trules) == \
            _jax_resolve(ax, sizes, jrules)[order]
    assert tshard.resolve(("vocab", "embed"), None) == \
        tuple(jshard.ShardingRules(None, {}).resolve(("vocab", "embed")))


FALLBACK = [(("embed", "vocab"), (6, 10)), (("embed", "mlp"), (4, 6)),
            (("batch", "heads", None), (6, 3, 5)),
            (("vocab", "embed"), (151936, 1026)),
            (("experts", "embed", "mlp"), (6, 8, 12)),
            (("batch", "kv_seq", "kv_heads", "head_dim"), (2, 7, 4, 8)),
            (("pages", None, "kv_heads", None), (9, 4, 2, 8)),
            (("heads_w", "heads_w"), (8, 8))]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_falls_back_as_jax_where_a_dim_does_not_divide(mesh, rules):
    sizes = MESHES[mesh]
    jrules, trules = RULES[rules]
    for axes, shape in FALLBACK:
        assert tshard.resolve(axes, sizes, trules, shape) == \
            _jax_resolve(axes, sizes, jrules, shape), (axes, shape)


def test_resolve_reads_a_rank_mesh():
    from repro_torch.launch.mesh import layout, production_layout

    grid = production_layout(multi_pod=True)
    assert tshard.mesh_axes(grid) == {"pod": 2, "data": 16, "model": 16}
    assert tshard.resolve(("embed", "vocab"), grid, {}, (64, 32)) == \
        (("pod", "data"), "model")
    serve = layout((3, 2), ("replica", "model"))
    assert tshard.resolve(("vocab", "embed"), serve,
                          tshard.MESH_SERVE_RULES) == ("model", None)
    with pytest.raises(TypeError, match="not a mesh"):
        tshard.mesh_axes(7)


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if a != "icf-cyclegan"))
def test_param_axes_name_every_parameter(arch):
    cfg = get_config(arch, smoke=True)
    model = tlm.init_lm(cfg, seed=0, device="cpu")
    axes = tshard.param_axes(cfg)
    params = dict(model.named_parameters())
    assert set(axes) == set(params)
    for name, p in params.items():
        assert len(axes[name]) == p.dim(), name


# ---------------------------------------------------------------------------
# the cut of the weights
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bridged(arch="qwen3-0.6b"):
    """JAX SMOKE weights (f32, numpy) and a port model holding them."""
    from repro.models import lm as jlm

    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = replace(get_config(arch, smoke=True), dtype="float32")
    params = jax.jit(lambda k: jlm.init_lm(jcfg, k)[0])(
        jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    bridge.load_jax_params(model, tree)
    return tree, model


def _expected(tree, cfg, M, r, heads):
    """Rank r's slices of the JAX arrays, by hand: JAX keeps (d_in,
    d_out), so an output-row cut is a column cut there."""
    def cols(a, n=M):
        w = a.shape[-1] // n
        return a[..., r * w:(r + 1) * w]

    def rows(a, n=M):
        w = a.shape[0] // n
        return a[r * w:(r + 1) * w]

    want = {"embed.weight": rows(tree["embed"]),
            "final_norm.scale": tree["final_norm"]["scale"]}
    body = tree["body"][0]
    for i in range(cfg.num_layers):
        b = jax.tree.map(lambda a: a[i], body)
        m, f = b["mixer"], b["ffn"]
        pre = f"blocks.{i}."
        want[pre + "ln1.scale"] = b["ln1"]["scale"]
        want[pre + "ln2.scale"] = b["ln2"]["scale"]
        for k in ("wq", "wk", "wv"):
            want[pre + f"mixer.{k}.weight"] = (cols(m[k]) if heads
                                               else m[k]).T
        want[pre + "mixer.wo.weight"] = (rows(m["wo"]) if heads
                                         else m["wo"]).T
        want[pre + "mixer.q_norm.scale"] = m["q_norm"]
        want[pre + "mixer.k_norm.scale"] = m["k_norm"]
        want[pre + "ffn.wi.weight"] = cols(f["wi"]).T
        want[pre + "ffn.wg.weight"] = cols(f["wg"]).T
        want[pre + "ffn.wo.weight"] = rows(f["wo"]).T
    return want


@pytest.mark.parametrize("M,heads", [(2, True), (4, False)],
                         ids=["model2", "model4_replicated_attention"])
def test_shard_lm_cuts_the_bridged_jax_weights(M, heads):
    """SMOKE qwen3 (H = 4, Hkv = 2): at model 2 the heads split; at model
    4 Hkv does not divide, so every rank keeps every head while the MLP
    and the vocab still split."""
    tree, model = _bridged()
    cfg = model.cfg
    plan = ttensor.plan_shards(cfg, {"data": 1, "model": M})
    assert (plan.heads, plan.mlp, plan.vocab) == (heads, True, True)
    rc = plan.rank_cfg
    assert (rc.num_heads, rc.num_kv_heads) == \
        ((cfg.num_heads // M, cfg.num_kv_heads // M) if heads
         else (cfg.num_heads, cfg.num_kv_heads))
    assert (rc.d_ff, rc.vocab_size, rc.head_dim) == \
        (cfg.d_ff // M, cfg.vocab_size // M, cfg.resolved_head_dim)
    for r in range(M):
        shard = ttensor.shard_lm(model, {"model": M}, r)
        direct = bridge.shard_from_jax(tree, cfg, {"model": M}, r,
                                       device="cpu")
        want = _expected(tree, cfg, M, r, heads)
        got = shard.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], torch.from_numpy(np.array(v))), k
            assert torch.equal(direct.state_dict()[k], got[k]), k
        tp = ttensor.tensor_parallel(shard)
        assert tp.size == M and tp.rank == r
        n = cfg.vocab_size // M
        assert tp.vocab == (r * n, (r + 1) * n)
        assert shard.tp is tp
        assert all((b.mixer.tp is tp) == heads and b.ffn.tp is tp
                   for b in shard.blocks)


def test_shard_plan_at_qwen3_full_width():
    """qwen3-0.6b FULL at model 2: 8 of 16 q heads and 4 of 8 kv heads a
    rank at the pinned width 128, d_ff 1536, the tied table's 75,968
    rows; at model 1 nothing is cut and no collective exists."""
    cfg = get_config("qwen3-0.6b")
    plan = ttensor.plan_shards(cfg, {"data": 4, "model": 2})
    rc = plan.rank_cfg
    assert (rc.num_heads, rc.num_kv_heads, rc.head_dim, rc.d_ff,
            rc.vocab_size) == (8, 4, 128, 1536, 75968)
    one = ttensor.plan_shards(cfg, {"data": 2, "model": 1})
    assert (one.heads, one.mlp, one.vocab) == (False, False, False)
    _, model = _bridged()
    whole = ttensor.shard_lm(model, {"model": 1}, 0)
    assert ttensor.tensor_parallel(whole) is None and whole.tp is None
    for k, v in model.state_dict().items():
        assert torch.equal(whole.state_dict()[k], v)


def test_a_shard_without_a_group_refuses_to_run_a_collective():
    _, model = _bridged()
    shard = ttensor.shard_lm(model, {"model": 2}, 1)
    with pytest.raises(RuntimeError, match="needs a process group"):
        tlm.lm_forward(shard, torch.zeros((1, 3), dtype=torch.long))


@pytest.mark.parametrize("arch,queue", [("xlstm-125m", "A20"),
                                        ("jamba-1.5-large-398b", "A20"),
                                        ("deepseek-moe-16b", "A19")])
def test_recurrent_and_moe_stacks_are_refused_over_the_model_axis(arch,
                                                                  queue):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match=queue):
        ttensor.plan_shards(cfg, {"model": 2})
    assert ttensor.plan_shards(cfg, {"model": 1}).size == 1


def test_hot_swap_into_a_shard_cuts_the_full_state():
    """``DecodeSession.set_params`` on a shard takes a full state dict in
    the port's layout and loads this rank's slices."""
    from repro_torch.serve.kv_cache import SlotLayout
    from repro_torch.serve.session import DecodeSession

    tree, model = _bridged()
    shard = ttensor.shard_lm(model, {"model": 2}, 1)
    sess = DecodeSession(model.cfg, shard,
                         SlotLayout(shard.cfg, 2, 8, device="cpu"))
    new = {k: v + 1 for k, v in model.state_dict().items()}
    sess.set_params(new)
    want = ttensor.plan_shards(model.cfg, {"model": 2}).shard_state(new, 1)
    for k, v in shard.state_dict().items():
        assert torch.equal(v, want[k]), k
