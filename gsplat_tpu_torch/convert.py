"""Carry weights and cameras across from the JAX package as numpy arrays.

`params_from_numpy` takes the six `GaussianParams` leaves,
`camera_from_numpy` the `Camera` fields and `train_state_from_numpy` the
`TrainState` fields, each as `np.asarray` of the JAX array, and returns the
port's types on `device`; `train_state_to_numpy` is the inverse of the last.
`train_state_from_jax_checkpoint` reads a checkpoint file of either package.
Nothing here imports JAX.
"""

from __future__ import annotations

import importlib
import pickle
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
    torch counterpart: the state gets a generator seeded with `seed`. A
    state the port wrote (`train_state_to_numpy`) carries its generator's
    state instead (`rng_state`, `rng_device`), which is restored when the
    state lands on the same device type.
    """
    from gsplat_tpu_torch.train.step import TrainState, make_generator

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    def tree(m):
        return {k: t(np.asarray(m[k], np.float32)) for k in PARAM_FIELDS}

    rng = make_generator(seed, device)
    if "rng_state" in d and d["rng_device"] == rng.device.type:
        rng.set_state(torch.from_numpy(np.asarray(d["rng_state"], np.uint8)))
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
        rng=rng,
        step=int(d["step"]),
    )


def train_state_tree(state) -> dict:
    """The port's `TrainState` as `train_state_from_numpy` reads it, with the
    tensors still on their device and the generator's state copied now: a
    densify round after this call draws from the generator and must not
    change what a later write of the tree stores."""
    return {
        "params": dict(state.params), "alive": state.alive, "adam_m": dict(state.adam_m),
        "adam_v": dict(state.adam_v), "adam_counts": state.adam_counts,
        "exposure": state.exposure, "exp_m": state.exp_m, "exp_v": state.exp_v,
        "exp_step": state.exp_step, "stats": dict(state.stats),
        "rng_state": state.rng.get_state().numpy(), "rng_device": state.rng.device.type,
        "step": int(state.step),
    }


def tree_to_numpy(tree):
    """Every tensor of a (nested) dict as a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def train_state_to_numpy(state) -> dict:
    """The port's `TrainState` as a plain dict of numpy arrays (no class
    references): it loads without the port's types and without a GPU."""
    return tree_to_numpy(train_state_tree(state))


class _Record:
    """Stands in for a JAX package dataclass in a checkpoint: keeps the
    fields the unpickler restores in `__dict__`."""


# what a pickle of numpy arrays refers to (numpy 1.x and 2.x module names)
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}


class _CheckpointUnpickler(pickle.Unpickler):
    """Loads numpy arrays and the JAX package's dataclasses, which become
    `_Record`s, and refuses every other class: no code of the JAX package
    runs, and a file that names anything else is not a checkpoint."""

    def find_class(self, module, name):
        if module == "gsplat_tpu" or module.startswith("gsplat_tpu."):
            return _Record
        if (module, name) in _NUMPY_GLOBALS:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}")


def _plain(obj):
    if isinstance(obj, _Record):
        obj = vars(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def read_checkpoint(path: str) -> dict:
    """{"state": {field: array or dict of arrays}, "iteration": int} of a
    checkpoint file written by either package."""
    with open(path, "rb") as f:
        return _plain(_CheckpointUnpickler(f).load())


def train_state_from_jax_checkpoint(path: str, device, seed: int = 0):
    """(the port's `TrainState`, iteration) from a `gsplat_tpu` checkpoint
    (`chkpnt<it>.pkl` or `rolling_chkpnt.pkl`, a pickle of its `TrainState`
    dataclass), read without importing `jax` or `gsplat_tpu`. The port's own
    checkpoints hold the same fields as a plain dict and load here too."""
    blob = read_checkpoint(path)
    return train_state_from_numpy(blob["state"], device, seed=seed), int(blob["iteration"])
