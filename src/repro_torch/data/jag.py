"""Synthetic JAG ICF simulator (a numpy copy of ``repro.data.jag``: the same
seed gives bit-identical samples and bundle files in either package).

The real data: 10M simulations from the JAG semi-analytic model — each
sample is (x: 5-D input params) -> (15 scalars, 12 X-ray images 64x64:
3 lines of sight x 4 hyperspectral channels), packed 1000 samples/file.

This module regenerates data with the same structure and qualitative
behavior (deterministic, smooth but strongly non-linear in the drive
parameters; shape parameters morph the images) so the CycleGAN + LTFB
experiments have real signal to learn.

x layout: x[0] = laser drive strength, x[1] = fuel fill,
          x[2:5] = 3 shape (asymmetry) parameters.  All in [0, 1].
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

NUM_INPUTS = 5
NUM_SCALARS = 15
NUM_VIEWS = 3
NUM_CHANNELS = 4
NUM_IMAGES = NUM_VIEWS * NUM_CHANNELS


def sample_inputs(n: int, seed: int = 0) -> np.ndarray:
    """Quasi-random coverage of the 5-D parameter space.

    The paper uses spectral space-filling sampling [12]; a scrambled
    Halton sequence gives the same dense-coverage property.
    """
    primes = [2, 3, 5, 7, 11]
    rng = np.random.default_rng(seed)
    shift = rng.random(NUM_INPUTS)
    idx = np.arange(1, n + 1)
    cols = []
    for p in primes:
        x = np.zeros(n)
        denom, i = p, idx.copy()
        while i.max() > 0:
            x += (i % p) / denom
            i //= p
            denom *= p
        cols.append(x)
    pts = (np.stack(cols, axis=1) + shift) % 1.0
    return pts.astype(np.float32)


def _scalars(x: np.ndarray) -> np.ndarray:
    """15 scalar observables; strongly non-linear in drive (paper §II-B)."""
    d, fill = x[:, 0], x[:, 1]
    s = x[:, 2:5]
    asym = np.linalg.norm(s - 0.5, axis=1)
    out = []
    yield_ = np.exp(4.0 * d) * (1.0 - 0.8 * asym ** 2) * (0.3 + fill)
    out.append(yield_)                                 # neutron yield
    out.append(np.log1p(yield_))                       # log yield
    tion = 1.0 + 3.0 * d ** 2 - asym                   # ion temperature
    out.append(tion)
    out.append(tion ** 2 / 4.0)                        # x-ray brightness
    out.append(0.5 + 0.5 * np.tanh(6.0 * (d - 0.55)))  # ignition proxy
    rho_r = (0.4 + d) * (1.0 - 0.5 * asym) * (0.5 + 0.5 * fill)
    out.append(rho_r)                                  # areal density
    out.append(np.sin(math.pi * d) * np.cos(2 * math.pi * s[:, 0]))
    out.append(s[:, 0] * s[:, 1] - s[:, 2] ** 2)
    out.append(np.exp(-8.0 * asym ** 2))               # symmetry metric
    out.append(d * fill)
    out.append(np.sqrt(np.maximum(yield_, 0)) * 0.1)
    out.append(np.cos(3 * math.pi * (d - asym)))
    out.append((1 - d) * asym)
    out.append(np.maximum(0.0, d - 2 * asym))          # margin
    out.append(0.2 + 0.6 * fill + 0.2 * np.sin(2 * math.pi * s[:, 1]))
    return np.stack(out, axis=1).astype(np.float32)


def _images(x: np.ndarray, size: int) -> np.ndarray:
    """(B, 12, size, size) capsule self-emission images.

    Ellipse with Legendre-like mode-2/3 perturbations from the shape
    params; per-channel (hyperspectral) energy falloff scales with drive;
    3 views rotate the asymmetry.
    """
    B = x.shape[0]
    d = x[:, 0][:, None, None]
    s = x[:, 2:5]
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2) + 1e-6
    th = np.arctan2(yy, xx)
    imgs = np.empty((B, NUM_IMAGES, size, size), np.float32)
    for v in range(NUM_VIEWS):
        phase = 2.0 * math.pi * v / NUM_VIEWS
        # mode-2 and mode-3 radius perturbation per sample
        p2 = (s[:, 0] - 0.5)[:, None, None]
        p3 = (s[:, 1] - 0.5)[:, None, None]
        rot = (s[:, 2] - 0.5)[:, None, None] * math.pi
        radius = 0.55 * (1.0 + 0.35 * p2 * np.cos(2 * (th + rot + phase))
                         + 0.25 * p3 * np.cos(3 * (th + rot + phase)))
        radius = np.maximum(radius, 0.05)
        shell = np.exp(-0.5 * ((r - radius) / (0.08 + 0.05 * (1 - d))) ** 2)
        core = np.exp(-0.5 * (r / (0.15 + 0.1 * d)) ** 2) * d
        base = shell + 1.5 * core
        for c in range(NUM_CHANNELS):
            # hyperspectral falloff: higher channels need hotter implosion
            gain = np.exp(-c * (1.2 - d))
            imgs[:, v * NUM_CHANNELS + c] = (base * gain).astype(np.float32)
    return imgs


def jag_simulate(x: np.ndarray, image_size: int = 64) -> Dict[str, np.ndarray]:
    """Run the synthetic JAG model. x: (B, 5) in [0,1]."""
    assert x.ndim == 2 and x.shape[1] == NUM_INPUTS
    return {"x": x.astype(np.float32),
            "scalars": _scalars(x),
            "images": _images(x, image_size)}


def flatten_outputs(sample: Dict[str, np.ndarray]) -> np.ndarray:
    """y bundle: (B, 15 + 12*size*size), normalized to O(1)."""
    B = sample["scalars"].shape[0]
    sc = sample["scalars"] / 10.0
    im = sample["images"].reshape(B, -1)
    return np.concatenate([sc, im], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Bundled sample files (stand-in for the paper's 1000-sample HDF5 bundles)
# ---------------------------------------------------------------------------


def bundle_path(root: str, i: int) -> str:
    """Path of bundle file ``i`` under ``root``."""
    return os.path.join(root, f"jag_{i:05d}.npz")


def write_bundles(root: str, num_samples: int, samples_per_file: int = 1000,
                  image_size: int = 64, seed: int = 0) -> List[str]:
    """Generate the dataset into `num_samples/samples_per_file` bundle
    files.  Samples are written in parameter-space exploration order —
    NOT shuffled — reproducing the paper's pathological file layout
    (Section IV-C: random minibatch sampling must touch many files)."""
    os.makedirs(root, exist_ok=True)
    xs = sample_inputs(num_samples, seed)
    paths = []
    for fi in range(0, num_samples, samples_per_file):
        batch = jag_simulate(xs[fi:fi + samples_per_file], image_size)
        path = bundle_path(root, fi // samples_per_file)
        np.savez(path, **batch)
        paths.append(path)
    return paths


def read_bundle(path: str) -> Dict[str, np.ndarray]:
    """One bundle file as ``{"x", "scalars", "images"}`` arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def list_bundles(root: str) -> List[str]:
    """Existing bundle manifest under `root` (sorted; [] if none)."""
    if not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.startswith("jag_") and f.endswith(".npz"))
