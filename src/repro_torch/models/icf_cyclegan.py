"""The paper's surrogate model: the CycleGAN for ICF
(``repro.models.icf_cyclegan``).

Components (all fully connected):
  * a multimodal autoencoder, encoder ``E: R^out -> R^20`` and decoder
    ``Dec: R^20 -> R^out`` over the output bundle y (15 scalars, 12
    images): internal consistency;
  * the forward model ``F: R^5 -> R^20`` into the AE latent;
  * the latent discriminator ``D: R^20 -> [0,1]`` (adversarial: F(x)
    latents against E(y) latents): physical consistency;
  * the inverse model ``G: R^20 -> R^5`` with ``G(F(x)) ~= x``: self
    consistency.

:class:`CycleGAN` holds the five stacks as ``nn.Linear`` layers with
``leaky_relu(0.2)`` between them and none after the last.  Training does
not go through the module: a trainer's weights are plain ``{name:
tensor}`` dicts, ``{"gen": {"fwd.0.weight": ..., "enc.1.bias": ...},
"disc": {"0.weight": ...}}`` (the module's parameter names under ``gen``
and ``disc``), and the functions below run them with ``F.linear``.  A step
returns new dicts and writes into none, so a generator that LTFB hands to
another trainer by reference is never changed under it.  The split into
``gen`` and ``disc`` lets the tournament exchange generators and keep
discriminators local.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.icf_cyclegan import CycleGANConfig

Tensors = Dict[str, torch.Tensor]
Params = Dict[str, Tensors]          # {"gen": Tensors, "disc": Tensors}
GEN_PARTS = ("fwd", "inv", "enc", "dec")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MLP(nn.ModuleList):
    """Fully-connected stack over ``dims``: ``leaky_relu(0.2)`` between
    layers, none after the last."""

    def __init__(self, dims: Sequence[int], dtype=torch.float32):
        super().__init__(nn.Linear(a, b, dtype=dtype)
                         for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the stack to ``x`` (..., dims[0])."""
        return mlp_apply(dict(self.named_parameters()), x)


class CycleGAN(nn.Module):
    """The generator stacks ``gen.{fwd, inv, enc, dec}`` and the latent
    discriminator ``disc``; ``forward`` is the surrogate prediction."""

    def __init__(self, cfg: CycleGANConfig):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        d_out, z = cfg.output_dim, cfg.latent_dim
        self.cfg = cfg
        self.gen = nn.ModuleDict({
            "fwd": MLP((cfg.input_dim, *cfg.fwd_hidden, z), dt),
            "inv": MLP((z, *cfg.inv_hidden, cfg.input_dim), dt),
            "enc": MLP((d_out, *cfg.enc_hidden, z), dt),
            "dec": MLP((z, *cfg.dec_hidden, d_out), dt)})
        self.disc = MLP((z, *cfg.disc_hidden, 1), dt)

    def params(self) -> Params:
        """The weights as a trainer holds them (detached, shared with the
        module's parameters)."""
        return {"gen": {n: p.detach() for n, p in
                        self.gen.named_parameters()},
                "disc": {n: p.detach() for n, p in
                         self.disc.named_parameters()}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Surrogate prediction: x (B, 5) -> output bundle (B, out)."""
        return predict(self.params()["gen"], x)


def init_cyclegan(cfg: CycleGANConfig, seed: int = 0,
                  device="cuda") -> Params:
    """Random weights from ``seed`` through a ``torch.Generator`` on
    ``device`` (the card unless the caller asks for ``"cpu"``): dense
    weights N(0, 1/d_in) and zero biases, as ``repro.models.layers.
    dense_init``.  The numbers differ from JAX's (another generator), so
    parity tests carry the JAX weights through :mod:`repro_torch.bridge`.
    """
    dev = resolve_device(device)
    with torch.device(dev):
        model = CycleGAN(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.normal_(generator=gen).mul_(1.0 / math.sqrt(p.shape[1]))
            else:
                p.zero_()
    return model.params()


def num_layers(p: Tensors, prefix: str = "") -> int:
    """Layers of the stack under ``prefix`` in a weights dict."""
    return sum(1 for k in p
               if k.startswith(prefix) and k.endswith(".weight"))


def mlp_apply(p: Tensors, x: torch.Tensor, prefix: str = ""
              ) -> torch.Tensor:
    """The stack ``prefix`` of ``p`` (``"fwd."``; ``""`` for a dict of one
    stack) on ``x``: ``x W^T + b``, ``leaky_relu(0.2)`` between layers."""
    n = num_layers(p, prefix)
    for i in range(n):
        x = F.linear(x, p[f"{prefix}{i}.weight"], p[f"{prefix}{i}.bias"])
        if i < n - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def forward_model(gen: Tensors, x: torch.Tensor) -> torch.Tensor:
    """F: experiment params (B, 5) -> latent (B, 20)."""
    return mlp_apply(gen, x, "fwd.")


def inverse_model(gen: Tensors, zlat: torch.Tensor) -> torch.Tensor:
    """G: latent -> experiment params."""
    return mlp_apply(gen, zlat, "inv.")


def encode(gen: Tensors, y: torch.Tensor) -> torch.Tensor:
    """E: output bundle -> latent."""
    return mlp_apply(gen, y, "enc.")


def decode(gen: Tensors, zlat: torch.Tensor) -> torch.Tensor:
    """Dec: latent -> output bundle."""
    return mlp_apply(gen, zlat, "dec.")


def discriminate(disc: Tensors, zlat: torch.Tensor) -> torch.Tensor:
    """D: latent -> logit (pre-sigmoid)."""
    return mlp_apply(disc, zlat)[..., 0]


def predict(gen: Tensors, x: torch.Tensor) -> torch.Tensor:
    """Surrogate prediction: x -> output bundle (scalars + images)."""
    return decode(gen, forward_model(gen, x))


# ---------------------------------------------------------------------------
# Losses (MAE for consistency, adversarial on the latent)
# ---------------------------------------------------------------------------


def _mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, gradient ``sigmoid(x)``
    (``F.softplus`` switches to ``x`` past its threshold instead)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _detached(p: Tensors) -> Tensors:
    return {n: t.detach() for n, t in p.items()}


def generator_loss(gen: Tensors, disc: Tensors, cfg: CycleGANConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``{'x': (B, 5), 'y': (B, output_dim)}``; the discriminator is
    frozen (no gradient reaches it)."""
    x, y = batch["x"], batch["y"]
    z_fake = forward_model(gen, x)
    z_real = encode(gen, y)
    y_hat = decode(gen, z_fake)
    y_rec = decode(gen, z_real)
    x_cyc = inverse_model(gen, z_fake)

    l_recon = _mae(y_rec, y)                        # AE reconstruction
    l_forward = _mae(y_hat, y)                      # internal consistency
    l_latent = _mae(z_fake, z_real.detach())
    l_cycle = _mae(x_cyc, x)                        # self consistency
    # non-saturating GAN loss against the (frozen) local discriminator
    logit_fake = discriminate(_detached(disc), z_fake)
    l_adv = torch.mean(softplus(-logit_fake))

    loss = (cfg.w_recon * l_recon + cfg.w_forward * (l_forward + l_latent)
            + cfg.w_cycle * l_cycle + cfg.w_adv * l_adv)
    metrics = {"recon": l_recon, "forward": l_forward, "cycle": l_cycle,
               "adv_gen": l_adv, "latent": l_latent}
    return loss, metrics


def discriminator_loss(disc: Tensors, gen: Tensors, cfg: CycleGANConfig,
                       batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Real latents E(y) against fake ones F(x), both detached; the
    accuracy is the mean of the two sides' correct-sign shares."""
    x, y = batch["x"], batch["y"]
    z_fake = forward_model(gen, x).detach()
    z_real = encode(gen, y).detach()
    logit_real = discriminate(disc, z_real)
    logit_fake = discriminate(disc, z_fake)
    loss = torch.mean(softplus(-logit_real)) \
        + torch.mean(softplus(logit_fake))
    acc = 0.5 * (torch.mean((logit_real > 0).float())
                 + torch.mean((logit_fake < 0).float()))
    return loss, {"disc_loss": loss, "disc_acc": acc}


def validation_metric(params: Params, cfg: CycleGANConfig,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Tournament / validation metric (lower is better): forward + inverse
    loss on held-out data, the paper's generalization measure."""
    gen = params["gen"]
    x, y = batch["x"], batch["y"]
    z = forward_model(gen, x)
    return _mae(decode(gen, z), y) + _mae(inverse_model(gen, z), x)


def discriminator_metric(params: Params, cfg: CycleGANConfig,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """GAN-LTFB tournament metric: how well a (possibly foreign) generator
    fools the LOCAL discriminator on tournament data (lower is better:
    mean softplus(-D(F(x))))."""
    logit = discriminate(params["disc"],
                         forward_model(params["gen"], batch["x"]))
    return torch.mean(softplus(-logit))
