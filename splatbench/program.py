"""The system under test: the few entry points of `gsplat_tpu_torch` that
the benchmark drives, and its types built from the benchmark's inputs.

Only this module imports the program, so a test can replace an entry
point in one place (`render`, `make_train_step`).
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import gsplat_tpu_torch
from gsplat_tpu_torch import render as _render
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.core.types import Camera, make_render_settings
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.train import step as _step

CHECKOUT = Path(__file__).resolve().parent.parent
if CHECKOUT not in Path(gsplat_tpu_torch.__file__).resolve().parents:
    raise SystemExit(f"the program under test is not this checkout's: {gsplat_tpu_torch.__file__}")

render = _render.render
make_train_step = _step.make_train_step
init_train_state = _step.init_train_state


def device(name):
    """The program's device (`cuda` pins float32 products to full float32)."""
    return resolve_device(name)


def settings(sh_degree, overrides):
    return make_render_settings(sh_degree=sh_degree, **overrides)


def camera(cam) -> Camera:
    """The program's camera from the benchmark's camera dict (same tensors)."""
    return Camera(world_view=cam["world_view"], full_proj=cam["full_proj"],
                  camera_center=cam["camera_center"], tan_fovx=cam["tan_fovx"],
                  tan_fovy=cam["tan_fovy"], width=cam["width"], height=cam["height"])


def params(leaves: dict):
    """The program's parameters from the benchmark's {field: tensor}."""
    return SimpleNamespace(**leaves)


def optimization(**fields) -> OptimizationConfig:
    return OptimizationConfig(**fields)
