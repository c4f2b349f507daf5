"""Entry points: the forward render of the seeded tiny scene on one card,
and the multi-device dryruns.

Counterpart of `__graft_entry__.py`. `entry()` returns `(fn, args)`, where
`fn(*args)` renders `synthetic.tiny_scene()` (4,096 gaussians, SH 3,
256x192) with float32 packets and the sorted blend and returns the (H, W,
3) image. On the card it runs K1' (expand and pack) and K2'. Unlike the JAX
entry it never falls back on its own: with no device given it runs on
`cuda` and raises without a card; `entry("cpu")` runs the plain twins.

`dryrun_multichip(n)` and `dryrun_multihost(n, hosts)` (`__graft_entry__.py:66,
225`) spawn n ranks (`parallel.comm.run_ranks`) and run one train step of
the seeded 1,024-gaussian scene through the band pipeline on each mesh the
JAX functions build, each loss held within relative 1e-5 of the
single-device step's on the same device. They return rank 0's summary.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.synthetic import tiny_scene


def entry(device=None):
    """(fn, example_args): the forward render of the tiny scene."""
    dev = resolve_device(device)
    params, alive, camera = tiny_scene(device=dev)
    settings = make_render_settings(sh_degree=3)

    def forward(params, alive):
        return render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=dev)["render"]

    return forward, (params, alive)


def _check_loss(what, got, want):
    """A sharded loss within relative 1e-5 of the single-device loss
    (absolute 1e-5 below 1), as the JAX dryruns require."""
    if not abs(got - want) <= 1e-5 * max(1.0, abs(want)):
        raise AssertionError(f"{what}: loss {got!r} != single-device loss {want!r}")
    return got


def _dryrun_case(mesh, width, height, gauss_axes=None, exchange=None, sharded_step=False):
    """One train step of the seeded 1,024-gaussian scene (2,048 rows, SH 1,
    hybrid packets, `__graft_entry__._tiny_scene`'s draws) on `mesh`, by
    the pipeline step or (`sharded_step`) `sharding.sharded_train_step`,
    and on one device: (sharded loss, single-device loss, band rows of a
    sharded render)."""
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.convert import PARAM_FIELDS
    from gsplat_tpu_torch.parallel.pipeline import make_pipeline_train_step, make_sharded_render
    from gsplat_tpu_torch.parallel.sharding import (
        place_train_state,
        shard_params,
        sharded_train_step,
    )
    from gsplat_tpu_torch.train.step import init_train_state, make_train_step

    dev = mesh.device
    settings = make_render_settings(sh_degree=1, packet_dtype="hybrid")
    params, alive, camera = tiny_scene(n=1024, width=width, height=height, sh_degree=1,
                                       capacity=2048, device=dev)
    state = init_train_state({k: getattr(params, k).detach().clone() for k in PARAM_FIELDS},
                             alive, num_images=2)
    zeros = torch.zeros((height, width), device=dev)
    args = (camera, torch.zeros((height, width, 3), device=dev),
            torch.ones((height, width, 1), device=dev), zeros, zeros, torch.zeros(3, device=dev),
            1e-4, 1e-3, 0.0, 0)
    opt = OptimizationConfig()
    want = float(make_train_step(opt, settings, use_exposure=True)(state, *args)[1]["loss"])
    if sharded_step:
        step, place = sharded_train_step(mesh, opt, settings, use_exposure=True)
    else:
        step = make_pipeline_train_step(mesh, opt, settings, width, height, use_exposure=True,
                                        gauss_axes=gauss_axes, exchange_capacity=exchange)

        def place(s):
            return place_train_state(mesh, s, gauss_axes)
    got = float(step(place(state), *args)[1]["loss"])
    with torch.no_grad():
        out = make_sharded_render(mesh, settings, width, height, gauss_axes, exchange)(
            camera, *shard_params(params, alive, mesh, gauss_axes), [0.0, 0.0, 0.0])
    return got, want, out["band_counts"]


def _dryrun_multichip_rank(device, backend):
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel.sharding import make_mesh

    n = dist.get_world_size()
    n_tile = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // n_tile, n_tile, backend=backend, device=device)
    # 1. the pipeline step (full gather) and 1b. the band exchange at 96x128
    got, want, _ = _dryrun_case(mesh, 128, 96)
    out = {"mesh": f"{n // n_tile}x{n_tile}", "single_device": want,
           "pipeline": _check_loss("pipeline", got, want)}
    out["band_exchange"] = _check_loss("band exchange", _dryrun_case(mesh, 128, 96, exchange=1)[0],
                                       want)
    # 2. the sharded step: the pipeline on the padded grid
    out["sharded_step"] = _check_loss("sharded step",
                                      _dryrun_case(mesh, 128, 96, sharded_step=True)[0], want)
    # 1c. the band exchange on every mesh shape of the JAX dryrun, 128x128
    out["shapes"] = {}
    for g, t in ((n, 1), (n // 2, 2), (n // 4, 4)):
        if g >= 1 and g * t == n:
            m = make_mesh(g, t, backend=backend, device=device)
            got, want, counts = _dryrun_case(m, 128, 128, exchange=1)
            out["shapes"][f"{g}x{t}"] = {"loss": _check_loss(f"band exchange {g}x{t}", got, want),
                                         "single_device": want, "band_counts": counts}
    return out


def _dryrun_multihost_rank(device, backend, n_hosts):
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel.sharding import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh(n // (n_hosts * 2), 2, backend=backend, device=device, n_host=n_hosts)
    got, want, _ = _dryrun_case(mesh, 128, 96, gauss_axes=("host", "gauss"))
    return {"mesh": "x".join(map(str, mesh.shape)), "axes": list(mesh.axes),
            "loss": _check_loss("multi-host pipeline", got, want), "single_device": want}


def _dryrun_backend(n_ranks, device, backend):
    from gsplat_tpu_torch.parallel import comm

    dev = resolve_device(device)
    backend = comm.check_backend(backend or comm.default_backend(dev))
    if backend == "nccl" and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"NCCL needs a card per rank: {n_ranks} ranks, "
                         f"{torch.cuda.device_count()} cards; pass backend='gloo'")
    return dev, backend


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """One train step on an n_devices mesh, several ways (`__graft_entry__.py:66`):
    the pipeline step on a (n/2 x 2) mesh (n x 1 when n is odd) with the
    full gather, the band exchange and the sharded step, then the band
    exchange on the (n x 1), (n/2 x 2) and (n/4 x 4) meshes at 128x128.
    Each loss is held within relative 1e-5 of the single-device loss.
    `device` defaults to `cuda`, `backend` to NCCL there (a card per rank)
    and gloo on the CPU; ranks that share a card need gloo."""
    from gsplat_tpu_torch.parallel import comm

    dev, backend = _dryrun_backend(n_devices, device, backend)
    out = comm.run_ranks(_dryrun_multichip_rank, n_devices, backend, args=(str(dev), backend),
                         threads=1 if dev.type == "cpu" else None)[0]
    print(f"dryrun_multichip OK: {n_devices} ranks ({backend}), mesh {out['mesh']}: pipeline "
          f"loss {out['pipeline']:.6f} == band exchange {out['band_exchange']:.6f} == sharded "
          f"step {out['sharded_step']:.6f} == single-device {out['single_device']:.6f}; "
          + "; ".join(f"{k}: loss {v['loss']:.6f}, band rows {v['band_counts']}"
                      for k, v in out["shapes"].items()))
    return out


def dryrun_multihost(n_devices: int = 8, n_hosts: int = 2, device=None, backend=None) -> dict:
    """One pipeline train step on a ("host", "gauss", "tile") mesh of
    n_hosts x n/(2 n_hosts) x 2 ranks (`__graft_entry__.py:225`), the rows
    split over ("host", "gauss") and gathered within a host first, then
    across hosts; its loss within relative 1e-5 of the single-device loss."""
    from gsplat_tpu_torch.parallel import comm

    dev, backend = _dryrun_backend(n_devices, device, backend)
    out = comm.run_ranks(_dryrun_multihost_rank, n_devices, backend,
                         args=(str(dev), backend, n_hosts),
                         threads=1 if dev.type == "cpu" else None)[0]
    print(f"dryrun_multihost OK: mesh {out['mesh']} {tuple(out['axes'])} ({backend}), loss "
          f"{out['loss']:.6f} == single-device {out['single_device']:.6f}")
    return out
