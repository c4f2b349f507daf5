"""Carry weights and cameras across from the JAX package as numpy arrays.

`params_from_numpy` takes the six `GaussianParams` leaves and
`camera_from_numpy` the `Camera` fields, each as `np.asarray` of the JAX
array, and returns the port's types on `device`. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gsplat_tpu_torch.core.types import Camera, GaussianParams

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def params_from_numpy(d: Mapping[str, np.ndarray], device) -> GaussianParams:
    """{field: array} of the six parameter leaves -> float32 GaussianParams."""
    return GaussianParams(
        **{k: torch.tensor(np.asarray(d[k], np.float32), device=device) for k in PARAM_FIELDS}
    )


def camera_from_numpy(world_view, full_proj, camera_center, tan_fovx, tan_fovy,
                      width: int, height: int, device) -> Camera:
    """Camera fields as arrays (or scalars) -> float32 Camera on `device`."""

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return Camera(
        world_view=f32(world_view),
        full_proj=f32(full_proj),
        camera_center=f32(camera_center),
        tan_fovx=f32(tan_fovx),
        tan_fovy=f32(tan_fovy),
        width=int(width),
        height=int(height),
    )
