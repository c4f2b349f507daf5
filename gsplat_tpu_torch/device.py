"""Device resolution shared by the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. With no device
given and no card present they raise: the port never falls back to the CPU
on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    `None` means `cuda`. A CUDA device is refused when no card is present.
    On a CUDA device, float32 matmuls and convolutions are pinned to full
    float32 (no TF32): the JAX package computes its small contractions at
    `Precision.HIGHEST`, and TF32 keeps only about three decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gsplat_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
