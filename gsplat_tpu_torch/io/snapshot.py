"""Model snapshot loading (reference `Scene.__init__ load_iteration` +
`GaussianModel.load_ply`); counterpart of `gsplat_tpu/io/snapshot.py`.

Rows are padded to a multiple of `pad_to_multiple` with dead rows, as in the
JAX package, so the two load the same arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gsplat_tpu_torch.convert import params_from_numpy
from gsplat_tpu_torch.data import ply as ply_io

# inert values of dead rows (`gsplat_tpu/train/densify.py:37`)
DEAD_PARAMS = dict(scaling=-15.0, opacity=-15.0)


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def sanitize_dead_rows(params: dict, alive: np.ndarray) -> dict:
    """Force dead rows to inert values (tiny scale, ~0 opacity, identity
    quaternion) so they cannot affect renders (`densify.py:40-48`)."""
    dead = ~alive
    out = dict(params)
    out["scaling"] = np.where(dead[:, None], np.float32(DEAD_PARAMS["scaling"]), params["scaling"])
    out["opacity"] = np.where(dead[:, None], np.float32(DEAD_PARAMS["opacity"]), params["opacity"])
    out["rotation"] = np.where(
        dead[:, None], np.array([1.0, 0.0, 0.0, 0.0], np.float32), params["rotation"]
    )
    return out


def search_max_iteration(point_cloud_dir: str) -> int:
    """`searchForMaxIteration` (`utils/system_utils.py:26-28`)."""
    iters = [
        int(d.split("_")[-1])
        for d in os.listdir(point_cloud_dir)
        if d.startswith("iteration_")
    ]
    if not iters:
        raise FileNotFoundError(f"no iteration_* snapshots under {point_cloud_dir}")
    return max(iters)


def load_snapshot(model_path: str, iteration: int = -1, pad_to_multiple: int = 256,
                  device="cuda"):
    """Load a trained model -> (params, alive, loaded_iteration, exposure dict),
    with params and alive on `device`."""
    pc_dir = os.path.join(model_path, "point_cloud")
    if iteration == -1:
        iteration = search_max_iteration(pc_dir)
    ply_path = os.path.join(pc_dir, f"iteration_{iteration}", "point_cloud.ply")
    raw = ply_io.load_gaussian_ply(ply_path)
    n = raw["xyz"].shape[0]
    cap = round_up(n, pad_to_multiple)

    def pad(a):
        return np.concatenate([a, np.zeros((cap - n,) + a.shape[1:], a.dtype)], axis=0)

    alive = np.arange(cap) < n
    params = sanitize_dead_rows({k: pad(v) for k, v in raw.items()}, alive)

    exposure = None
    exp_path = os.path.join(model_path, "exposure.json")
    if os.path.exists(exp_path):
        with open(exp_path) as f:
            exposure = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
    return (
        params_from_numpy(params, device),
        torch.as_tensor(alive, device=device),
        iteration,
        exposure,
    )
