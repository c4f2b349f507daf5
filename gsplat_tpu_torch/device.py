"""Device resolution shared by the port's entry points, and the card's
identification line that every measurement is printed beside.

Entry points run on `cuda` unless the caller asks for the CPU. With no device
given and no card present they raise: the port never falls back to the CPU
on its own.
"""

from __future__ import annotations

import subprocess

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


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (a card may be set below
    its maximum power and then runs slower under load)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]
