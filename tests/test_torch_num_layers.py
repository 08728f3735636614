"""``--num-layers``: the ltfb CLI trains an LM cut to its first N layers at
full width, and the serve CLI serves that population (CPU, SMOKE).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import ltfb as tltfb
from repro_torch.launch import serve as tserve

LTFB = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--trainers",
        "2", "--rounds", "1", "--steps-per-round", "2", "--batch", "2",
        "--seq", "16", "--samples", "48", "--samples-per-file", "16"]


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    """A 1-layer SMOKE qwen3 population (SMOKE has 2 layers)."""
    root = tmp_path_factory.mktemp("cut")
    pop, data = str(root / "pop"), str(root / "data")
    assert tltfb.main([*LTFB, "--num-layers", "1", "--ckpt-dir", pop,
                       "--data-dir", data]) == 0
    return pop


def test_lm_config_cuts_depth_at_full_width():
    args = tltfb.finish_args(tltfb.build_parser().parse_args(
        [*LTFB, "--num-layers", "1"]))
    cfg = tltfb.lm_config(args)
    full = tltfb.get_config("qwen3-0.6b", smoke=True)
    assert full.num_layers == 2 and cfg.num_layers == 1
    assert (cfg.d_model, cfg.vocab_size) == (full.d_model, full.vocab_size)
    args.num_layers = None
    assert tltfb.lm_config(args).num_layers == 2


def test_serve_cli_serves_a_cut_population(population):
    out = tserve.run_lm(tserve.build_parser().parse_args(
        ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--ckpt-dir",
         population, "--num-layers", "1", "--requests", "3"]))
    assert out["stats"]["completed"] == 3
    assert out["registry_step"] is not None
