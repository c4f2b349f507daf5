"""The COLMAP quality run with the projection on its plain twins.

    python -m gsplat_tpu_torch.scripts.plain_projection --out DIR [--seed 0]
        [--iterations 30000] [--device cuda] [--small]

Runs `colmap_proxy`'s chain in this process (`--in_process`, no
trained-cloud report) with `preprocess` routed to the forward twin
`preprocess_torch` and, for its backward, to autograd of that twin, on the
card as on the CPU: the route the quality run took before the projection
kernels (`gs_project_fwd`, `gs_project_bwd`). Against `colmap_proxy`'s run
on the same seed, a difference in quality is the kernels' share or the
chaos of training from different roundings; against this route's own runs
on other seeds, the spread. DIR/summary.json is `colmap_proxy`'s, with
`"projection": "plain"` added.

    python -m gsplat_tpu_torch.scripts.plain_projection --out DIR --compare ITER [ITER ...]

trains nothing: on the snapshots at ITER of the run in DIR (`colmap_proxy`'s
or this script's), `snapshot_check` holds the backward kernel against
autograd on every train view, and DIR/projection_compare.json gets its
numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import torch

from gsplat_tpu_torch.ops import projection as pj
from gsplat_tpu_torch.scripts import colmap_proxy as cp

_LEAVES = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")


def autograd_bwd(params, alive, camera, settings, cotangents, with_offset=True):
    """`project_bwd`'s contract, computed by autograd of `preprocess_torch`
    (the offset's gradient does not depend on its value, nor any gradient
    on the tile grid)."""
    leaves = {k: getattr(params, k).detach().requires_grad_(True) for k in _LEAVES}
    offset = torch.zeros((alive.shape[0], 2), dtype=params.xyz.dtype, device=alive.device,
                         requires_grad=True)
    inputs = [leaves[k] for k in _LEAVES] + [offset]
    with torch.enable_grad():
        s = pj.preprocess_torch(SimpleNamespace(**leaves), alive, camera, settings, 1, 1, offset)
        pairs = [(o, c) for o, c in zip((s.mean2d, s.conic, s.opacity, s.rgb, s.depth),
                                        cotangents) if c is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], inputs, [c for _, c in pairs],
                                    allow_unused=True) if pairs else [None] * len(inputs)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs)]
    return (*grads[:6], grads[6] if with_offset else None)


@contextlib.contextmanager
def plain_route():
    """`preprocess` on the twins, with autograd for the backward, on every
    device, while the context lasts."""
    saved = pj.project_fwd, pj.project_bwd, pj.preprocess_bwd_torch
    pj.project_fwd = pj.preprocess_torch
    pj.project_bwd = pj.preprocess_bwd_torch = autograd_bwd
    try:
        yield
    finally:
        pj.project_fwd, pj.project_bwd, pj.preprocess_bwd_torch = saved


def _float64(params, camera, cotangents):
    cam = dataclasses.replace(camera, **{f: getattr(camera, f).double() for f in (
        "world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")})
    return (SimpleNamespace(**{k: getattr(params, k).double() for k in _LEAVES}), cam,
            [None if c is None else c.double() for c in cotangents])


def column_error(got, want, alive):
    """The largest error of `got` against `want` over the live rows, per
    gradient component (one column over the gaussians) relative to that
    column's largest magnitude in `want`, entries that are not finite in
    either left out (and counted)."""
    worst, nonfinite = 0.0, 0
    for g, w in zip(got, want):
        g, w = g[alive].reshape(int(alive.sum()), -1).double(), w[alive].reshape(
            int(alive.sum()), -1).double()
        fin = torch.isfinite(g) & torch.isfinite(w)
        nonfinite += int((~fin).sum())
        g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
        scale = w.abs().amax(dim=0)
        err = (g - w).abs().amax(dim=0)
        worst = max(worst, float(torch.where(scale > 0, err / scale,
                                             torch.where(err > 0, torch.inf, 0.0)).max()))
    return worst, nonfinite


def snapshot_check(model_dir, scene_dir, iteration, device="cuda", lambda_dssim=0.2):
    """The backward kernel on a trained state: the run's snapshot at
    `iteration`, every train view rendered and differentiated as the train
    step does (the photometric loss to the view's image, black background,
    the densification offset, hybrid packets), which hands `project_bwd` its
    inputs. There the kernel's gradients and autograd of `preprocess_torch`
    in float32 are each held against autograd in float64 (`column_error`),
    and the kernel's against its twin `preprocess_bwd_torch`, bit for bit.
    Returns per view both errors, the equality and the visible rows."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.io.snapshot import load_snapshot
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.train import losses

    params, alive, _, _ = load_snapshot(model_dir, iteration, device=device)
    cams = load_scene(scene_dir, device, eval=True).get_train_cameras()
    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid")
    bg = torch.zeros(3, device=device)
    # the backward `ProjectFunction` calls on this device (the twin on the CPU)
    name = "project_bwd" if torch.device(device).type == "cuda" else "preprocess_bwd_torch"
    kernel, seen = getattr(pj, name), {}

    def spy(*a, **kw):
        seen["args"], seen["grads"] = a, kernel(*a, **kw)
        return seen["grads"]

    # the kernel counts through its module-global name: here onto the spy,
    # so that these launches stay off the kernel's own count
    spy.__dict__.update({c: 0 for c in vars(kernel) if c.startswith("launches")})

    views = []
    setattr(pj, name, spy)
    try:
        for holder in cams:
            leaves = {k: getattr(params, k).detach().requires_grad_(True) for k in _LEAVES}
            offset = torch.zeros((alive.shape[0], 2), device=device, requires_grad=True)
            out = render(holder.camera, SimpleNamespace(**leaves), alive, settings, bg,
                         mean2d_offset=offset, device=device)
            gt = torch.as_tensor(holder.image, device=device)
            loss, _ = losses.photometric_loss(out["render"], gt, lambda_dssim)
            torch.autograd.grad(loss, [*leaves.values(), offset])
            p, a, camera, st, cot = seen["args"][:5]
            got = seen["grads"]
            want32 = autograd_bwd(p, a, camera, st, cot)
            p64, camera64, cot64 = _float64(p, camera, cot)
            want64 = autograd_bwd(p64, a, camera64, st, cot64)
            with torch.no_grad():
                twin = pj.preprocess_bwd_torch(p, a, camera, st, cot)
            k_err, k_nonfinite = column_error(got, want64, a)
            a_err, a_nonfinite = column_error(want32, want64, a)
            views.append({"view": holder.image_name, "kernel_vs_float64": k_err,
                          "autograd_vs_float64": a_err, "nonfinite": [k_nonfinite, a_nonfinite],
                          "equal_to_twin": all(torch.equal(x.view(torch.int32), y.view(
                              torch.int32)) for x, y in zip(got, twin)),
                          "visible": int(out["visibility"].sum())})
    finally:
        setattr(pj, name, kernel)
    return {"iteration": iteration, "live": int(alive.sum()), "views": views}


def main(argv=None):
    p = argparse.ArgumentParser(description="the COLMAP quality run, projection on its twins")
    p.add_argument("--out", required=True, help="run directory: scene/, model/, summary.json")
    p.add_argument("--seed", type=int, default=0, help="the train seed (the scene's is fixed)")
    p.add_argument("--iterations", type=int, default=cp.ITERATIONS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--small", action="store_true",
                   help="the small scene of a CPU rehearsal (SMALL_RECIPE), not the recipe's")
    p.add_argument("--compare", type=int, nargs="+", default=None, metavar="ITER",
                   help="train nothing: hold the backward kernel against autograd on DIR's "
                        "snapshots at ITER")
    args = p.parse_args(argv)
    if args.compare:
        res = [snapshot_check(os.path.join(args.out, "model"), os.path.join(args.out, "scene"),
                              it, args.device) for it in args.compare]
        with open(os.path.join(args.out, "projection_compare.json"), "w") as f:
            json.dump(res, f, indent=1)
        for r in res:
            print(json.dumps({"iteration": r["iteration"], "live": r["live"],
                              "kernel_vs_float64": max(v["kernel_vs_float64"] for v in r["views"]),
                              "autograd_vs_float64": max(v["autograd_vs_float64"]
                                                         for v in r["views"])}))
        return 0
    with plain_route():
        rc = cp.main(["--out", args.out, "--seed", str(args.seed), "--iterations",
                      str(args.iterations), "--device", args.device, "--in_process",
                      "--skip_report"] + (["--small"] if args.small else []))
    if rc:
        return rc
    path = os.path.join(args.out, "summary.json")
    with open(path) as f:
        summary = json.load(f)
    summary["model"]["projection"] = "plain"
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
