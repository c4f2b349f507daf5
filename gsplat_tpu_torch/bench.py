"""The port's benchmark: rasterizer pixels/s at 1080p on one card.

    python -m gsplat_tpu_torch.bench                      # on the card
    python -m gsplat_tpu_torch.bench --device cpu --n 4096 --width 256 --height 192

Counterpart of the top-level `bench.py` (`measure`, `measure_render_only`)
at its points, on the seeded garden-class scene (`synthetic.tiny_scene`,
the port's copy of `__graft_entry__._tiny_scene`) with no padding rows
(`capacity=n`):

- the gradient of the render's mean at 1,048,576 gaussians, 1920x1080,
  hybrid packets (the headline) and float32 packets (the parity path);
- the same at 262,144 gaussians (a quarter of `--n`), hybrid;
- the forward render alone (no autograd) at 1,048,576, hybrid;
- the forward render alone of trained clouds (`measure_render_only_trained`,
  `bench.py:112-175`), added by `main` only: the candidate runs of
  `TRAINED_CANDIDATES` are scanned newest first (`bench.py:191-210`) and
  the first snapshot of each scene that exists is rendered; a scene with
  none gets no row. The Blender scenes' runs read their sources under
  `NERF_SYNTHETIC`; the COLMAP quality runs (`scripts/colmap_proxy.py`)
  hold their own scene. `run` leaves them out, so its points do not depend
  on what earlier runs left in the working directory.

Each point runs one warm-up call, then 8 timed calls (20 for the forward
alone) on the host clock, ending in `torch.cuda.synchronize()`. Beside
every pixels/s it gives `ms`, that clock per call, and `device_ms`, the
card's busy time per call over 3 profiled calls (the union of the
profiler's device intervals, `profiling.py`), which no slow host stretches.
It prints one JSON line with `bench.py`'s keys, plus the card's name and
power limit as `nvidia-smi` gives them. It runs on `cuda` and raises
without a card; `--device cpu` runs the plain twins at a small `--n` as a
rehearsal, where `device_ms` is null and the times are the host's.

`vs_baseline` is against the reference's only published render rate, the
3DGS paper's >= 30 fps at 1080p (1920*1080*30 pixels/s, forward only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.device import card_line, resolve_device
from gsplat_tpu_torch.profiling import device_ms_per_call
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.synthetic import tiny_scene

BASELINE_PIXELS_PER_S = 1920 * 1080 * 30.0
GRAD_ITERS, RENDER_ITERS, PROFILED_CALLS = 8, 20, 3
# no real frame is faster: a faster reading is flagged, not reported
FAKE_FAST_MS = 2.0
# trained runs, newest first per scene (`bench.py:193-203`); the COLMAP
# quality runs keep their scene beside their model
TRAINED_CANDIDATES = {
    "chair": ["output/seeds_r5/chair_seed1", "output/seeds_r5/chair_seed2",
              "output/full_eval_r5/chair", "output/full_eval_r3/chair"],
    "ship": ["output/full_eval_r5/ship", "output/full_eval_r3/ship"],
    "lego": ["output/sparse_ab_r5/lego_dense", "output/sparse_ab_r5/lego_sparse"],
    "mic": ["output/full_eval_r5/mic"],
}
COLMAP_CANDIDATES = ["output/colmap_proxy_torch/seed0", "output/colmap_proxy_torch/seed1"]
NERF_SYNTHETIC = "nerf_synthetic"  # the Blender scenes' sources


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rate(fn, iters, dev, width, height) -> dict:
    """One warm-up call, `iters` calls on the host clock, then the device
    time per call (card only)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    return {"pixels_per_s": width * height / dt, "ms": dt * 1e3,
            "device_ms": device_ms_per_call(fn, PROFILED_CALLS) if dev.type == "cuda" else None}


def measure(n: int, packet_dtype="float32", width: int = 1920, height: int = 1080,
            iters: int = GRAD_ITERS, device=None) -> dict:
    """Forward + backward: the gradient of the render's mean w.r.t. every
    parameter (`bench.py:32-74`)."""
    dev = resolve_device(device)
    params, alive, camera = tiny_scene(n=n, width=width, height=height, sh_degree=3,
                                       capacity=n, device=dev)
    settings = make_render_settings(sh_degree=3, packet_dtype=packet_dtype)
    leaves = list(params.parameters())
    instances = []

    def step():
        out = render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=dev)
        loss = out["render"].mean() + 0.0 * out["invdepth"].mean()
        instances.append(out["num_instances"])
        return torch.autograd.grad(loss, leaves)

    res = _rate(step, iters, dev, width, height)
    return {**res, "gaussians": n, "instances": int(instances[-1])}


def measure_render_only(n: int, packet_dtype="hybrid", width: int = 1920, height: int = 1080,
                        iters: int = RENDER_ITERS, device=None) -> dict:
    """The forward render alone, no autograd: the serving rate
    (`bench.py:77-109`)."""
    dev = resolve_device(device)
    params, alive, camera = tiny_scene(n=n, width=width, height=height, sh_degree=3,
                                       capacity=n, device=dev)
    settings = make_render_settings(sh_degree=3, packet_dtype=packet_dtype)

    def frame():
        with torch.no_grad():
            return render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=dev)["render"]

    return {**_rate(frame, iters, dev, width, height), "gaussians": n}


def measure_render_only_trained(model_dir: str, source: str, packet_dtype="hybrid",
                                iters: int = RENDER_ITERS, iteration: int = 30_000,
                                device=None):
    """The forward render alone of a trained snapshot (`model_dir`'s
    `point_cloud/iteration_<iteration>`) on the first train view of
    `source`, white background (`bench.py:112-175`). None when either
    directory is absent: trained clouds are run outputs, not part of the
    repository. A time under `FAKE_FAST_MS` is measured once more, then
    flagged `invalid` rather than reported."""
    if not (os.path.isdir(model_dir) and os.path.isdir(source)):
        return None
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.io.snapshot import load_snapshot

    dev = resolve_device(device)
    params, alive, _, _ = load_snapshot(model_dir, iteration, device=dev)
    scene = load_scene(source, dev, eval=True, white_background=True)
    cam = scene.get_train_cameras()[0].camera
    settings = make_render_settings(sh_degree=3, packet_dtype=packet_dtype)

    def frame():
        with torch.no_grad():
            return render(cam, params, alive, settings, [1.0, 1.0, 1.0], device=dev)["render"]

    def timed():
        frame()  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            frame()
        _sync(dev)
        return (time.perf_counter() - t0) / iters

    dt = timed()
    if dt * 1e3 < FAKE_FAST_MS:
        dt = timed()
    if dt * 1e3 < FAKE_FAST_MS:
        return {"invalid": "transport_glitch_fake_fast", "ms": dt * 1e3}
    px = cam.width * cam.height
    return {"pixels_per_s": px / dt, "ms": dt * 1e3, "n_gauss": int(alive.sum()),
            "vs_baseline": px / dt / BASELINE_PIXELS_PER_S}


def trained_rows(device=None) -> dict:
    """The first trained snapshot that exists of each scene, rendered
    (`bench.py:191-210`): `<scene>_30k_800px` for the Blender scenes,
    `colmap_proxy_30k_400x304` for the COLMAP quality run."""
    candidates = [(f"{name}_30k_800px", d, os.path.join(NERF_SYNTHETIC, name))
                  for name, dirs in TRAINED_CANDIDATES.items() for d in dirs]
    candidates += [("colmap_proxy_30k_400x304", os.path.join(d, "model"), os.path.join(d, "scene"))
                   for d in COLMAP_CANDIDATES]
    rows = {}
    for row, model_dir, source in candidates:
        if row in rows:
            continue
        try:
            r = measure_render_only_trained(model_dir, source, device=device)
        except (OSError, ValueError):
            r = None  # a run without its 30k snapshot, or a scene that does not load
        if r is not None:
            rows[row] = r
    return rows


def card(dev) -> dict:
    """The device the numbers were taken on."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "nvidia_smi": card_line()}


def run(n: int = 1_048_576, width: int = 1920, height: int = 1080, device=None) -> dict:
    """Every point but the trained clouds', as one dict with `bench.py`'s
    keys."""
    dev = resolve_device(device)
    kw = dict(width=width, height=height, device=dev)
    garden = measure(n, "hybrid", **kw)
    garden_f32 = measure(n, "float32", **kw)
    small = measure(n // 4, "hybrid", **kw)
    render_only = measure_render_only(n, "hybrid", **kw)
    px = width * height

    def vs(r):
        return r["pixels_per_s"] / BASELINE_PIXELS_PER_S

    def ns_per_instance(r):
        return 1e9 * (px / r["pixels_per_s"]) / max(r["instances"], 1)

    return {
        "metric": "pixels/s/card fwd+bwd, 1080p, 1M gaussians (garden-class)",
        "value": garden["pixels_per_s"],
        "unit": "pixels/s",
        "vs_baseline": vs(garden),
        "points": {
            "1M_gauss": {**garden, "ns_per_instance": ns_per_instance(garden)},
            "1M_gauss_f32_parity": {**garden_f32, "vs_baseline": vs(garden_f32)},
            "262k_gauss": {**small, "ns_per_instance": ns_per_instance(small),
                           "vs_baseline": vs(small)},
            "render_only": {"1M_gauss_1080p": {**render_only, "vs_baseline": vs(render_only)}},
        },
        "size": f"{width}x{height}",
        "device": card(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gsplat_tpu_torch rasterizer benchmark")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--n", type=int, default=1_048_576,
                        help="gaussians of the large points (the small one takes n // 4)")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    args = parser.parse_args(argv)
    res = run(args.n, args.width, args.height, args.device)
    res["points"]["render_only"].update(trained_rows(args.device))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
