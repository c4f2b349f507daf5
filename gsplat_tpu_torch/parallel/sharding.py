"""Gaussian-sharded, tile-banded execution over a device mesh.

Counterpart of `gsplat_tpu/parallel/sharding.py`, with its names and
contracts, over `torch.distributed` with one process per rank:

- axis "gauss": the gaussian rows are split row-wise over the ranks; the
  preprocess, the Adam state and the densification stats of a row live on
  the ranks of its shard (on a multi-host mesh the rows are split over
  ("host", "gauss") together);
- axis "tile": the image's tile rows are split into bands; each rank
  blends its band, and the gradients of the bands meet in a sum over
  "tile".

PyTorch has no SPMD partitioner, so `sharded_render` and
`sharded_train_step` run the explicit pipeline of `pipeline.py` (the full
gather), on a tile grid padded to a multiple of the tile axis where it does
not divide. Placing a state slices its row leaves for this rank and keeps
the replicated ones (exposure and its moments, `step`, the generator);
gathering it is the inverse, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.core.types import GaussianParams, RenderSettings
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.parallel import comm
from gsplat_tpu_torch.parallel.pipeline import (
    gauss_axes_of,
    make_pipeline_train_step,
    make_sharded_render,
)

# TrainState fields with one row per gaussian; the others are replicated
ROW_LEAVES = ("params", "adam_m", "adam_v", "alive", "adam_counts", "stats")


def make_mesh(n_gauss: int | None = None, n_tile: int | None = None, backend: str | None = None,
              device=None, n_host: int = 1) -> comm.Mesh:
    """This rank's ("gauss", "tile") mesh over the job's process group, or
    its ("host", "gauss", "tile") mesh when `n_host` > 1.

    Defaults as `make_mesh` of the JAX package: all ranks on the gauss
    axis. `device` (default `cuda`) is resolved per rank
    (`comm.rank_device`); `backend` defaults to NCCL on `cuda` and gloo on
    the CPU. Every rank must call this, in the same order.
    """
    if not torch.distributed.is_initialized():
        raise RuntimeError("make_mesh: join the process group first (comm.init_distributed)")
    dev = resolve_device(device)
    backend = comm.check_backend(backend or comm.default_backend(dev))
    n = torch.distributed.get_world_size() // n_host
    if n_gauss is None and n_tile is None:
        n_gauss, n_tile = n, 1
    elif n_gauss is None:
        n_gauss = n // n_tile
    elif n_tile is None:
        n_tile = n // n_gauss
    if n_host > 1:
        axes, shape = ("host", "gauss", "tile"), (n_host, n_gauss, n_tile)
    else:
        axes, shape = ("gauss", "tile"), (n_gauss, n_tile)
    dev = comm.rank_device(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return comm.make_mesh_groups(axes, shape, backend, dev)


def parse_mesh(spec: str) -> tuple:
    """(G, T) of a `--mesh GxT` string."""
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh must be 'GxT' (e.g. 4x2), got {spec!r}")
    return int(parts[0]), int(parts[1])


def param_spec(mesh: comm.Mesh, capacity: int, gauss_axes=None) -> range:
    """This rank's rows of a `capacity`-row table: a contiguous range, the
    shard at its row-major index along the gaussian axes."""
    gaxes = gauss_axes_of(mesh, gauss_axes)
    g = mesh.size(gaxes)
    if capacity % g:
        raise ValueError(f"capacity {capacity} does not divide over {g} gaussian shards")
    rows = capacity // g
    start = mesh.index(gaxes) * rows
    return range(start, start + rows)


def mesh_capacity(capacity: int, mesh: comm.Mesh, gauss_axes=None) -> int:
    """`capacity` rounded up to a multiple of the gaussian shards."""
    g = mesh.size(gauss_axes_of(mesh, gauss_axes))
    return -(-int(capacity) // g) * g


def pad_rows(params, alive, capacity: int):
    """(params, alive) padded with dead rows to `capacity` (dead rows hold
    the sanitized values of `densify.sanitize_dead_rows`)."""
    from gsplat_tpu_torch.train.densify import sanitize_dead_rows

    pad = capacity - alive.shape[0]
    if pad == 0:
        return params, alive
    tree = {k: getattr(params, k).detach() for k in PARAM_FIELDS}
    tree = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))]) for k, v in tree.items()}
    alive = torch.cat([alive, alive.new_zeros(pad)])
    return GaussianParams(**sanitize_dead_rows(tree, alive)), alive


def _rows(x, rows: range, device):
    return x[rows.start:rows.stop].to(device).clone()


def shard_params(params, alive, mesh: comm.Mesh, gauss_axes=None):
    """(GaussianParams, alive) of this rank's rows on its device."""
    rows = param_spec(mesh, alive.shape[0], gauss_axes)
    local = GaussianParams(**{k: _rows(getattr(params, k).detach(), rows, mesh.device)
                              for k in PARAM_FIELDS})
    return local, _rows(torch.as_tensor(alive), rows, mesh.device)


def train_state_shardings(mesh: comm.Mesh, state, gauss_axes=None) -> dict:
    """{TrainState field: "rows" or "replicated"}: the row leaves split over
    the gaussian axes, everything else on every rank."""
    return {f.name: "rows" if f.name in ROW_LEAVES else "replicated"
            for f in dataclasses.fields(state)}


def _map(fn, leaf):
    return {k: fn(v) for k, v in leaf.items()} if isinstance(leaf, dict) else fn(leaf)


def place_train_state(mesh: comm.Mesh, state, gauss_axes=None):
    """This rank's part of a whole TrainState (initially, after a resize and
    after a resume): its row range of every row leaf, every replicated
    tensor as it is, all on the rank's device; the generator is kept."""
    rows = param_spec(mesh, state.capacity, gauss_axes)
    tree = {name: _map(lambda x: _rows(x, rows, mesh.device), getattr(state, name))
            for name in ROW_LEAVES}
    repl = {k: getattr(state, k).to(mesh.device) for k in ("exposure", "exp_m", "exp_v",
                                                            "exp_step")}
    return dataclasses.replace(state, **tree, **repl)


def gather_train_state(mesh: comm.Mesh, state, gauss_axes=None):
    """The whole TrainState from every rank's part: the inverse of
    `place_train_state`, bit for bit. One all_gather per dtype."""
    gaxes = gauss_axes_of(mesh, gauss_axes)
    leaves = [(name, key, leaf) for name in ROW_LEAVES
              for key, leaf in (getattr(state, name).items() if isinstance(getattr(state, name), dict)
                                else [(None, getattr(state, name))])]
    n = state.capacity
    out = {}
    for dtype in dict.fromkeys(leaf.dtype for _, _, leaf in leaves):
        group = [(name, key, leaf) for name, key, leaf in leaves if leaf.dtype == dtype]
        packed = torch.cat([leaf.reshape(n, -1) for _, _, leaf in group], dim=1)
        full = comm.all_gather(packed, mesh, gaxes, "gather_state")
        col = 0
        for name, key, leaf in group:
            w = math.prod(leaf.shape[1:])
            out[(name, key)] = full[:, col:col + w].reshape((-1,) + tuple(leaf.shape[1:])).clone()
            col += w
    tree = {}
    for name in ROW_LEAVES:
        leaf = getattr(state, name)
        tree[name] = ({k: out[(name, k)] for k in leaf} if isinstance(leaf, dict)
                      else out[(name, None)])
    return dataclasses.replace(state, **tree)


def sharded_render(mesh: comm.Mesh, settings: RenderSettings):
    """fn(camera, params, alive, bg) -> the render dict of
    `pipeline.make_sharded_render` (full gather) for the camera's size, with
    params and alive of this rank's rows (`shard_params`)."""
    cache = {}

    def _render(camera, params, alive, bg):
        key = (camera.width, camera.height)
        if key not in cache:
            cache[key] = make_sharded_render(mesh, settings, *key)
        return cache[key](camera, params, alive, bg)

    return _render


def sharded_train_step(mesh: comm.Mesh, opt, settings: RenderSettings, use_exposure=False):
    """(step, place_state): the train step of `make_train_step` for a mesh
    (the pipeline with the full gather, built per camera size, on a tile
    grid padded to a multiple of the tile axis), and the function that
    places a whole state on the mesh."""
    cache = {}

    def step(state, camera, *args):
        key = (camera.width, camera.height)
        if key not in cache:
            cache[key] = make_pipeline_train_step(mesh, opt, settings, *key,
                                                  use_exposure=use_exposure)
        return cache[key](state, camera, *args)

    def place_state(state):
        return place_train_state(mesh, state)

    return step, place_state
