"""Seeded synthetic scene: the port's copy of `__graft_entry__._tiny_scene`.

Same numpy seed and draws, so the same (n, capacity, sh_degree) gives the
same arrays as the JAX package's generator. At n = 1,048,576, SH degree 3
and 1920x1080 it is the repo's flagship garden-class scene.
"""

from __future__ import annotations

import numpy as np
import torch

from gsplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from gsplat_tpu_torch.utils.graphics import projection_matrix, world_to_view


def tiny_scene(n=4096, width=256, height=192, sh_degree=3, capacity=None, device="cuda"):
    """(GaussianParams, alive, Camera) on `device`."""
    rng = np.random.default_rng(0)
    capacity = capacity or n
    k = (sh_degree + 1) ** 2
    params = dict(
        xyz=rng.normal(0, 1.0, (capacity, 3)).astype(np.float32),
        features_dc=rng.normal(0, 0.3, (capacity, 1, 3)).astype(np.float32),
        features_rest=rng.normal(0, 0.02, (capacity, k - 1, 3)).astype(np.float32),
        # scales sized for a trained-scene tile footprint (~2-8 tiles per
        # gaussian at this camera)
        scaling=np.log(rng.uniform(0.002, 0.012, (capacity, 3))).astype(np.float32),
        rotation=rng.normal(0, 1, (capacity, 4)).astype(np.float32),
        opacity=rng.normal(0, 1, (capacity, 1)).astype(np.float32),
    )
    alive = np.arange(capacity) < n
    fovx, fovy = 0.9, 0.7
    w2v = world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = projection_matrix(0.01, 100.0, fovx, fovy)
    camera = dict(
        world_view=w2v,
        full_proj=(proj @ w2v).astype(np.float32),
        camera_center=np.linalg.inv(w2v)[:3, 3].astype(np.float32),
        tan_fovx=np.float32(np.tan(fovx / 2)),
        tan_fovy=np.float32(np.tan(fovy / 2)),
        width=width,
        height=height,
    )
    return (
        params_from_numpy(params, device),
        torch.as_tensor(alive, device=device),
        camera_from_numpy(**camera, device=device),
    )
