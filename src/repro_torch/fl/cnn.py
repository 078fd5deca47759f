"""The paper's CNN (§IV) in PyTorch: Conv(32,3x3)+ReLU -> MaxPool(2x2)
-> Flatten -> Dense(64)+ReLU -> Dense(n_classes).

Parameters keep the JAX package's layout — a dict with ``conv_w``
HWIO, ``dense*_w`` [in, out], and ``dense1_w``'s rows in the NHWC
flatten order of the pooled map — so the flat delta is the same vector
in both packages and carrying weights across is a plain copy.  The
ops permute at the call instead: HWIO -> OIHW for ``F.conv2d`` and
NCHW -> NHWC before the flatten.  Inputs are NHWC, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import PaperCNNConfig

PARAM_NAMES = ("conv_b", "conv_w", "dense1_b", "dense1_w", "dense2_b",
               "dense2_w")


def init_cnn(generator: torch.Generator, cfg: PaperCNNConfig
             ) -> Dict[str, torch.Tensor]:
    """Random init from a ``torch.Generator`` (scaled normals, zero
    biases, as ``repro.fl.cnn.init_cnn``).  torch's generator is not
    JAX's ``PRNGKey``, so the numbers differ from the JAX package's at
    the same seed; to start both from one init, carry JAX's with
    :func:`params_from_jax`."""
    def normal(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return w / math.sqrt(fan)

    zeros = lambda n: torch.zeros(n, dtype=torch.float32)
    return {
        "conv_w": normal((3, 3, cfg.channels, cfg.conv_filters),
                         3 * 3 * cfg.channels),
        "conv_b": zeros(cfg.conv_filters),
        "dense1_w": normal((cfg.flat_dim, cfg.dense_units), cfg.flat_dim),
        "dense1_b": zeros(cfg.dense_units),
        "dense2_w": normal((cfg.dense_units, cfg.n_classes),
                           cfg.dense_units),
        "dense2_b": zeros(cfg.n_classes),
    }


def params_from_jax(np_params: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX CNN params (as numpy arrays) -> the port's params: the same
    layout, so a copy."""
    return {k: torch.tensor(np.asarray(np_params[k], np.float32))
            for k in PARAM_NAMES}


def params_to_jax(params: Dict[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: numpy arrays ready for
    ``jnp.asarray``."""
    return {k: params[k].detach().cpu().numpy() for k in PARAM_NAMES}


def cnn_forward(params: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    """x: [B, H, W, C] -> logits [B, n_classes]."""
    h = F.conv2d(x.permute(0, 3, 1, 2), params["conv_w"].permute(3, 2, 0, 1))
    h = F.relu(h + params["conv_b"][:, None, None])
    h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["dense1_w"] + params["dense1_b"])
    return h @ params["dense2_w"] + params["dense2_b"]


def cnn_loss(params, x, y) -> torch.Tensor:
    logp = F.log_softmax(cnn_forward(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


@torch.no_grad()
def cnn_accuracy(params, x, y, batch: int = 512) -> float:
    correct = 0
    for i in range(0, x.shape[0], batch):
        logits = cnn_forward(params, x[i:i + batch])
        correct += int(torch.sum(torch.argmax(logits, -1) == y[i:i + batch]))
    return correct / x.shape[0]
