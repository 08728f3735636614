"""Architecture registry of the port: ``--arch <id>`` resolution.

Every architecture of ``repro.configs.registry`` resolves here, FULL
(published widths) and SMOKE (the reduced config of the CPU tests), equal
to the JAX package's field by field; an unknown arch raises ``KeyError``.
Two FULL configs do not fit one 80 GB card, and their modules hold the cut
the port runs there: ``jamba_15_large.NOEXP_8L`` (one period, no experts)
and ``phi35_moe.CUT_16L`` (16 of 32 layers).  ``icf-cyclegan`` resolves to
a :class:`CycleGANConfig`, not an LM config: the train and LTFB launchers
train it, the LM code paths refuse it.
"""
from __future__ import annotations

from typing import Dict, Union

from repro_torch.configs import (codeqwen15, deepseek_moe, granite_8b,
                                 icf_cyclegan, jamba_15_large,
                                 musicgen_medium, phi35_moe, qwen2_vl,
                                 qwen3_06b, qwen25_3b, xlstm_125m)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.icf_cyclegan import CycleGANConfig

# the LM archs, in the JAX registry's order
_MODULES = (phi35_moe, deepseek_moe, codeqwen15, qwen3_06b, qwen25_3b,
            granite_8b, xlstm_125m, qwen2_vl, jamba_15_large,
            musicgen_medium)

ARCHS: Dict[str, object] = {m.ARCH_ID: m for m in _MODULES}
ARCHS[icf_cyclegan.ARCH_ID] = icf_cyclegan


def get_config(arch_id: str, smoke: bool = False
               ) -> Union[ModelConfig, CycleGANConfig]:
    """FULL (published widths) or SMOKE config of an arch."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    mod = ARCHS[arch_id]
    return mod.SMOKE if smoke else mod.FULL
