"""Carry weights of the JAX package's dense LM into the port.

Input is the JAX params pytree already converted to numpy (the caller
runs ``jax.tree.map(np.asarray, params)``; this module imports no JAX):

* ``embed`` (V, d);
* ``body``: a 1-tuple holding the per-layer-stacked leaves, each with a
  leading layer axis — ``ln1.scale``, ``mixer.{wq, wk, wv, wo}`` (plus
  ``bq, bk, bv`` with qkv bias and ``q_norm, k_norm`` with qk-norm),
  ``ln2.scale``, ``ffn.{wi, wg, wo}``;
* ``final_norm.scale``; ``lm_head`` (d, V) only when embeddings are not
  tied.

JAX keeps dense weights ``(d_in, d_out)`` for ``x @ W``; the port's
``nn.Linear`` keeps ``(d_out, d_in)``, so they are transposed here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """State dict for :class:`repro_torch.models.lm.LM` from the JAX tree."""
    if len(tree["body"]) != 1:
        raise ValueError("the bridge carries dense stacks (one period); "
                         f"got {len(tree['body'])} periods")
    body = tree["body"][0]
    mix, ffn = body["mixer"], body["ffn"]
    sd = {"embed.weight": tree["embed"],
          "final_norm.scale": tree["final_norm"]["scale"]}
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        sd[p + "ln1.scale"] = body["ln1"]["scale"][i]
        sd[p + "ln2.scale"] = body["ln2"]["scale"][i]
        for n in ("wq", "wk", "wv", "wo"):
            sd[p + f"mixer.{n}.weight"] = np.asarray(mix[n][i]).T
        if cfg.qkv_bias:
            for n in ("q", "k", "v"):
                sd[p + f"mixer.w{n}.bias"] = mix["b" + n][i]
        if cfg.qk_norm:
            sd[p + "mixer.q_norm.scale"] = mix["q_norm"][i]
            sd[p + "mixer.k_norm.scale"] = mix["k_norm"][i]
        for n in ("wi", "wg", "wo"):
            sd[p + f"ffn.{n}.weight"] = np.asarray(ffn[n][i]).T
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = np.asarray(tree["lm_head"]).T
    return {k: _tensor(v) for k, v in sd.items()}


def load_jax_params(model: LM, tree) -> LM:
    """Copy the JAX weights into ``model`` (strict: every key must match;
    values are cast to the model's dtype and device)."""
    model.load_state_dict(params_from_jax(tree, model.cfg), strict=True)
    return model
