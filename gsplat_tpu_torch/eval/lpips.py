"""LPIPS perceptual metric (VGG16 backbone) in PyTorch.

Counterpart of `gsplat_tpu/eval/lpips_jax.py`, a re-implementation of the
reference's `lpipsPyTorch/` module (VGG16 feature stack, unit-normalized
channel activations, learned linear weights, spatial average,
`lpipsPyTorch/modules/lpips.py`). The reference downloads the torchvision
VGG16 weights and R. Zhang's LPIPS linear weights at run time
(`lpipsPyTorch/modules/utils.py:12-20`); here they are read from disk, in
the JAX package's format:

    GSPLAT_LPIPS_WEIGHTS=/path/to/lpips_vgg.npz

The .npz holds `conv_<i>_w`/`conv_<i>_b` (VGG16 features, OIHW) and
`lin_<k>_w` (the 1x1 LPIPS heads, (C,)); `scripts/convert_lpips_weights.py`
converts the torch checkpoints. When the file is absent,
`lpips_available()` is False and the metrics CLI reports LPIPS as null.

The VGG convolutions are `F.conv2d` (library convolutions, as the JAX
package's are `lax.conv` outside any Pallas kernel), on the images' device,
in full float32: `device.resolve_device` turns TF32 off on the card.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from gsplat_tpu_torch.device import resolve_device

# VGG16 feature-extractor conv layout: (out_channels, n_convs) per block;
# LPIPS taps the activations after each block's last ReLU (pre-pool).
VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def weights_path() -> str | None:
    p = os.environ.get("GSPLAT_LPIPS_WEIGHTS", "")
    if p and os.path.exists(p):
        return p
    default = os.path.join(os.path.dirname(__file__), "lpips_vgg.npz")
    return default if os.path.exists(default) else None


def lpips_available() -> bool:
    return weights_path() is not None


@lru_cache(maxsize=4)
def _load_weights(device: torch.device):
    """(convs [(w, b)], lins [w]) on `device`, read once per device."""
    path = weights_path()
    if path is None:
        raise FileNotFoundError(
            "LPIPS weights not found — set GSPLAT_LPIPS_WEIGHTS (see module docstring)"
        )
    with np.load(path) as blob:
        def t(name):
            return torch.tensor(blob[name], device=device)

        convs = []
        while f"conv_{len(convs)}_w" in blob:
            i = len(convs)
            convs.append((t(f"conv_{i}_w"), t(f"conv_{i}_b")))
        lins = []
        while f"lin_{len(lins)}_w" in blob:
            lins.append(t(f"lin_{len(lins)}_w"))
    return convs, lins


def _vgg_features(x, convs):
    """x: (1, 3, H, W) normalized. Returns the 5 block activations."""
    feats = []
    ci = 0
    for _, n_convs in VGG16_BLOCKS:
        for _ in range(n_convs):
            w, b = convs[ci]
            ci += 1
            x = F.relu(F.conv2d(x, w, b, padding=1))
        feats.append(x)
        x = F.max_pool2d(x, 2)  # floor: the JAX package's VALID reduce_window
    return feats


def lpips(img1, img2):
    """LPIPS(vgg) of a pair of (H, W, 3) float32 images in [0, 1], as a 0-d
    tensor on their device.

    As the reference pipeline (`lpipsPyTorch/modules/`): the [0, 1] image is
    z-scored directly (`networks.py:50-51`: no rescale to [-1, 1] first),
    activations are normalized as x / (||x||_c + 1e-10) (`utils.py:6-8`),
    squared differences go through the 1x1 linear heads and a spatial mean,
    summed over the five taps (`lpips.py:31-36`).
    """
    dev = resolve_device(img1.device)
    convs, lins = _load_weights(dev)
    shift = torch.from_numpy(_SHIFT).to(dev)
    scale = torch.from_numpy(_SCALE).to(dev)

    def prep(img):
        return torch.movedim((img - shift) / scale, -1, 0)[None]  # (1, 3, H, W)

    with torch.no_grad():
        f1 = _vgg_features(prep(img1), convs)
        f2 = _vgg_features(prep(img2), convs)
        total = torch.zeros((), device=dev)
        for a, b, w in zip(f1, f2, lins):
            na = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            d = (na - nb) ** 2  # (1, C, H, W)
            total = total + torch.mean(torch.sum(d * w[None, :, None, None], dim=1))
    return total
