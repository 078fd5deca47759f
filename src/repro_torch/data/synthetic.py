"""Synthetic datasets.

This container is offline, so CIFAR-10/100 / Fashion-MNIST cannot be
downloaded; the FL experiments instead use *structured* synthetic image
classification problems that are genuinely learnable (class-conditional
templates + per-sample deformation + noise) with the same tensor shapes
as the paper's datasets.  The learning dynamics (non-trivial accuracy
growth over FL rounds, sensitivity to quantization error) are what the
paper's tables measure; absolute accuracy values are not comparable to
the paper's and EXPERIMENTS.md reports them as such.

A numpy copy of ``repro.data.synthetic``'s image half: the same seed
gives the same arrays in both packages, so parity tests share data.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray          # [N, H, W, C] float32 in [0, 1]
    y: np.ndarray          # [N] int64
    n_classes: int

    def __len__(self):
        return self.x.shape[0]


def make_image_classification(n_samples: int = 10_000, hw: int = 32,
                              channels: int = 3, n_classes: int = 10,
                              noise: float = 0.35, seed: int = 0
                              ) -> ImageDataset:
    """Class-conditional low-frequency templates + jitter + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    templates = []
    for c in range(n_classes):
        fx, fy = rng.uniform(1.0, 4.0, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        base = (np.sin(2 * np.pi * fx * xx + phase[0])
                * np.cos(2 * np.pi * fy * yy + phase[1]))
        chan = rng.uniform(0.3, 1.0, channels)
        templates.append(base[..., None] * chan[None, None, :])
    templates = np.stack(templates)                   # [C, H, W, ch]

    y = rng.integers(0, n_classes, n_samples)
    shifts = rng.integers(-3, 4, (n_samples, 2))
    x = np.empty((n_samples, hw, hw, channels), np.float32)
    for i in range(n_samples):
        t = np.roll(templates[y[i]], shifts[i], axis=(0, 1))
        x[i] = t + noise * rng.standard_normal(t.shape)
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return ImageDataset(x=x.astype(np.float32), y=y.astype(np.int64),
                        n_classes=n_classes)

