"""Carry weights and cameras across from the JAX package as numpy arrays.

`params_from_numpy` takes the six `GaussianParams` leaves,
`camera_from_numpy` the `Camera` fields and `train_state_from_numpy` the
`TrainState` fields, each as `np.asarray` of the JAX array, and returns the
port's types on `device`. Nothing here imports JAX.
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


def train_state_from_numpy(d: Mapping, device, seed: int = 0):
    """A JAX `TrainState` as numpy arrays -> the port's `TrainState`.

    `d` maps the JAX field names to arrays; `params`, `adam_m`, `adam_v`
    and `stats` map their leaves' names to arrays. The JAX PRNG key has no
    torch counterpart: the state gets a generator seeded with `seed`.
    """
    from gsplat_tpu_torch.train.step import TrainState, make_generator

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    def tree(m):
        return {k: t(np.asarray(m[k], np.float32)) for k in PARAM_FIELDS}

    return TrainState(
        params=tree(d["params"]),
        alive=t(np.asarray(d["alive"], bool)),
        adam_m=tree(d["adam_m"]),
        adam_v=tree(d["adam_v"]),
        adam_counts=t(np.asarray(d["adam_counts"], np.int32)),
        exposure=t(np.asarray(d["exposure"], np.float32)),
        exp_m=t(np.asarray(d["exp_m"], np.float32)),
        exp_v=t(np.asarray(d["exp_v"], np.float32)),
        exp_step=t(np.asarray(d["exp_step"], np.int32)),
        stats={k: t(v) for k, v in d["stats"].items()},
        rng=make_generator(seed, device),
        step=int(d["step"]),
    )
