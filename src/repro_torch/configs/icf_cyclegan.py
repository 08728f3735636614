"""The paper's own model: the CycleGAN surrogate for ICF (a copy of
``repro.configs.icf_cyclegan``).

Forward model F: R^5 -> R^20 (the latent of a multimodal autoencoder over
15 scalars + 12 x 64x64 X-ray images), an adversarial latent discriminator
D: R^20 -> {0,1}, and an inverse model G: R^20 -> R^5 with G(F(x)) ~= x.
Every component is a fully-connected network.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

ARCH_ID = "icf-cyclegan"


@dataclass(frozen=True)
class CycleGANConfig:
    """Widths, loss weights and dtype of the CycleGAN."""

    name: str = ARCH_ID
    family: str = "cyclegan"

    # JAG sample modality structure (paper Section II-B)
    input_dim: int = 5               # 5-D experiment parameter space
    num_scalars: int = 15            # 15 scalar observables
    num_images: int = 12             # 3 lines of sight x 4 channels
    image_size: int = 64             # 64 x 64 pixels
    latent_dim: int = 20             # 20-D latent space

    # network widths (fully connected)
    fwd_hidden: Tuple[int, ...] = (64, 128, 64)      # F: 5 -> 20
    inv_hidden: Tuple[int, ...] = (64, 128, 64)      # G: 20 -> 5
    disc_hidden: Tuple[int, ...] = (64, 64)          # D: 20 -> 1
    enc_hidden: Tuple[int, ...] = (1024, 256)        # AE encoder -> 20
    dec_hidden: Tuple[int, ...] = (256, 1024)        # AE decoder 20 -> out

    # loss weights (MAE everywhere; adversarial on the latent)
    w_forward: float = 1.0           # | F(x) - E(y) | internal consistency
    w_cycle: float = 1.0             # | G(F(x)) - x | self consistency
    w_adv: float = 0.1               # adversarial (physical consistency)
    w_recon: float = 1.0             # AE reconstruction

    dtype: str = "float32"           # paper: single precision

    @property
    def output_dim(self) -> int:
        """Length of the flattened output bundle y: scalars + images."""
        return self.num_scalars + self.num_images * self.image_size ** 2

    def param_count(self) -> int:
        """Weights and biases of all five MLPs."""
        def mlp(dims):
            return sum(dims[i] * dims[i + 1] + dims[i + 1]
                       for i in range(len(dims) - 1))
        d_out = self.output_dim
        n = mlp((self.input_dim, *self.fwd_hidden, self.latent_dim))
        n += mlp((self.latent_dim, *self.inv_hidden, self.input_dim))
        n += mlp((self.latent_dim, *self.disc_hidden, 1))
        n += mlp((d_out, *self.enc_hidden, self.latent_dim))
        n += mlp((self.latent_dim, *self.dec_hidden, d_out))
        return n


FULL = CycleGANConfig()

# Reduced config for fast CPU tests: 8x8 images, narrow nets.
SMOKE = CycleGANConfig(
    name=ARCH_ID + "-smoke",
    image_size=8,
    fwd_hidden=(32, 32), inv_hidden=(32, 32), disc_hidden=(32,),
    enc_hidden=(64,), dec_hidden=(64,),
)
