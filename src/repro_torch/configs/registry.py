"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures the port runs so far are registered; every other
arch of ``repro.configs.registry`` raises ``NotImplementedError``.
``jamba-1.5-large-398b`` resolves to its published config, whose MoE
layers raise when a model is built (ROADMAP queue A8); the port serves
``jamba_15_large.NOEXP_8L``, one period without experts.
``icf-cyclegan`` resolves to a :class:`CycleGANConfig`, not an LM config:
the train and LTFB launchers train it, the LM code paths refuse it.
"""
from __future__ import annotations

from typing import Dict, Union

from repro_torch.configs import (icf_cyclegan, jamba_15_large, qwen3_06b,
                                 xlstm_125m)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.icf_cyclegan import CycleGANConfig

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in (qwen3_06b, xlstm_125m,
                                                   jamba_15_large,
                                                   icf_cyclegan)}

# archs of the JAX package the port does not run yet (ROADMAP queue A)
UNPORTED = (
    "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b", "codeqwen1.5-7b",
    "qwen2.5-3b", "granite-8b", "qwen2-vl-7b", "musicgen-medium",
)


def get_config(arch_id: str, smoke: bool = False
               ) -> Union[ModelConfig, CycleGANConfig]:
    """FULL (published widths) or SMOKE config of a ported arch."""
    if arch_id in ARCHS:
        mod = ARCHS[arch_id]
        return mod.SMOKE if smoke else mod.FULL
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; see "
            "ROADMAP.md queue A for the order the port takes")
    raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(ARCHS)}")
