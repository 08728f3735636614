"""PyTorch/CUDA port of the ``repro`` system for NVIDIA Hopper: LTFB
tournament training of the ICF CycleGAN and of the LM archs, LM training,
and serving (the LMs with speculative decoding, the CycleGAN surrogate).

The package mirrors ``repro``'s layout (``configs``, ``core``, ``data``,
``datastore``, ``checkpoint``, ``kernels``, ``models``, ``optim``,
``train``, ``serve``, ``launch``) but imports neither JAX nor anything of
``repro``: it keeps its own copy of what it needs.  Every entry point runs
on the CUDA card unless the caller passes ``device="cpu"``; on the CPU the
kernels' plain PyTorch versions stand in for the hand-written kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` is every entry point's default; when no card is visible it
    raises instead of quietly falling back to the CPU — pass
    ``device="cpu"`` to ask for the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run on the CPU with the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
