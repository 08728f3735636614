"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures the port serves so far are registered; every other
arch of ``repro.configs.registry`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import qwen3_06b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, object] = {qwen3_06b.ARCH_ID: qwen3_06b}

# archs of the JAX package the port does not serve yet (ROADMAP queue A)
UNPORTED = (
    "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b", "codeqwen1.5-7b",
    "qwen2.5-3b", "granite-8b", "xlstm-125m", "qwen2-vl-7b",
    "jamba-1.5-large-398b", "musicgen-medium", "icf-cyclegan",
)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """FULL (published widths) or SMOKE config of a ported arch."""
    if arch_id in ARCHS:
        mod = ARCHS[arch_id]
        return mod.SMOKE if smoke else mod.FULL
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A for the order the port takes")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(ARCHS)}")
