"""Model construction: point-cloud init, capacity padding, exposure state.

Counterpart of `gsplat_tpu/model.py`. The reference builds its parameters
in `GaussianModel.create_from_pcd` (`scene/gaussian_model.py:149-176`): SH
DC from RGB, log-scales from the mean 3-NN squared distance, identity
quaternions, opacity 0.1. As in the JAX package the init lands in a
static-`capacity` set of rows with an `alive` mask (see `train/densify.py`).
Parameters are a dict {field: (capacity, ...) float32 tensor}.
"""

from __future__ import annotations

import numpy as np
import torch

from gsplat_tpu_torch.core.sh import rgb_to_sh
from gsplat_tpu_torch.core.spatial import mean_knn_sq_dist
from gsplat_tpu_torch.io.snapshot import round_up
from gsplat_tpu_torch.train.densify import sanitize_dead_rows


def init_from_pcd(points, colors, max_sh_degree: int = 3, capacity: int | None = None,
                  capacity_multiplier: float = 2.0, device="cuda"):
    """Build (params dict, alive) on `device` from an SfM/random point cloud.

    Args:
      points: (N, 3) positions; colors: (N, 3) RGB in [0, 1].
      max_sh_degree: maximum SH degree (3 in the reference).
      capacity: total row count; default rounds N * capacity_multiplier up
        to a multiple of 4096, as the JAX package does.
    """
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n = points.shape[0]
    if capacity is None:
        capacity = round_up(max(int(n * capacity_multiplier), 4096), 4096)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")

    k_max = (max_sh_degree + 1) ** 2
    pts = torch.tensor(points, device=device)
    # log-scale from mean 3-NN squared distance (`gaussian_model.py:156-160`)
    dist2 = torch.clamp(mean_knn_sq_dist(pts), min=1e-7)
    rows = {
        "xyz": pts,
        "features_dc": rgb_to_sh(torch.tensor(colors, device=device))[:, None, :],
        "features_rest": torch.zeros((n, k_max - 1, 3), device=device),
        "scaling": torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        "rotation": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1),
        "opacity": torch.full((n, 1), float(torch.log(torch.tensor(0.1 / 0.9))), device=device),
    }
    params = {
        k: torch.cat([v, v.new_zeros((capacity - n,) + tuple(v.shape[1:]))])
        for k, v in rows.items()
    }
    alive = torch.arange(capacity, device=device) < n
    # dead rows: tiny scale, identity quaternion, ~0 opacity
    return sanitize_dead_rows(params, alive), alive


def init_exposure(num_images: int, device="cuda"):
    """Per-image identity (3, 4) exposure affines (`gaussian_model.py:166-172`)."""
    eye = torch.zeros((num_images, 3, 4), dtype=torch.float32, device=device)
    eye[:, :3, :3] = torch.eye(3, device=device)
    return eye
