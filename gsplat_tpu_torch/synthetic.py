"""Seeded synthetic scene: the port's copy of `__graft_entry__._tiny_scene`.

Same numpy seed and draws, so the same (n, capacity, sh_degree) gives the
same arrays as the JAX package's generator. At n = 1,048,576, SH degree 3
and 1920x1080 it is the repo's flagship garden-class scene. Also a table
of parameter rows that sit on the projection's edges
(`projection_edge_table`).
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


PROJECTION_EDGE_KINDS = ("near", "frustum_clamp", "det_zero", "opacity_255", "sh_zero",
                         "tile_border")


def projection_edge_table(camera, device, each=256, dead_every=7, seed=11):
    """Parameter rows (SH degree 4) built to sit on the projection's edges
    for `camera` (`tiny_scene`'s: world axes are view axes), `each` of each
    kind of `PROJECTION_EDGE_KINDS`: view z at 0.2 and a few float32 steps
    of the world grid around it; centres past the 1.3 tan_fov clamp (ndc
    1.2-1.4); splats of ~1e4 px along a diagonal and 1e-4 across, so that
    the dilated 2D determinant rounds to exactly 0 for some; opacities whose
    op*255 sits within 1e-6 of 1 and of the tight cull's 0.999999; SH
    colours of exactly 0 and one float32 step below and above
    (features_rest 0); and centres 0-8 px off a tile border with radii of a
    few px, so that rect edges fall on the borders. Every `dead_every`-th
    row is dead. Returns (params, alive, kind of each row)."""
    from types import SimpleNamespace

    from gsplat_tpu_torch.core import sh as sh_lib

    rng = np.random.default_rng(seed)
    m, nk = each, len(PROJECTION_EDGE_KINDS)
    W = camera.world_view.double().cpu().numpy()
    tx, ty = float(camera.tan_fovx), float(camera.tan_fovy)
    z = rng.uniform(1.5, 4.0, (nk, m))
    ndc = rng.uniform(-0.8, 0.8, (nk, 2, m))
    z[0] = 0.2 + rng.integers(-3, 4, m) * 2.384185791015625e-07  # float32 steps at |z - 4|
    ndc[0] = rng.uniform(-0.2, 0.2, (2, m))
    ndc[1] = rng.uniform(1.2, 1.4, (2, m)) * rng.choice([-1.0, 1.0], (2, m))
    w, h = camera.width, camera.height
    px = 16.0 * rng.integers(1, w // 16 - 1, m) + rng.integers(-8, 9, m)
    py = 16.0 * rng.integers(1, h // 16 - 1, m) + rng.integers(-8, 9, m)
    ndc[5] = np.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1])
    view = np.stack([ndc[:, 0] * z * tx, ndc[:, 1] * z * ty, z, np.ones_like(z)]).reshape(4, -1)
    xyz = (np.linalg.inv(W) @ view)[:3].T.astype(np.float32)
    n = nk * m
    k = sh_lib.num_sh_coeffs(4)
    scaling = np.log(rng.uniform(0.002, 0.012, (n, 3)))
    rotation = rng.normal(0, 1, (n, 4))
    opacity = rng.normal(0, 1, (n, 1))
    dc = rng.normal(0, 0.3, (n, 1, 3))
    rest = rng.normal(0, 0.02, (n, k - 1, 3))
    sel = slice(2 * m, 3 * m)  # det_zero: long axis in the image plane, diagonal
    scaling[sel] = np.stack([rng.uniform(3.0, 4.5, m), np.full(m, -9.0), np.full(m, -9.0)], 1)
    half = rng.uniform(0.3, 1.2, m) / 2
    rotation[sel] = np.stack([np.cos(half), np.zeros(m), np.zeros(m), np.sin(half)], 1)
    sel = slice(3 * m, 4 * m)  # op * 255 at 1 and at 0.999999, within 1e-6
    p = np.where(rng.random(m) < 0.5, 1.0, 0.999999) / 255 * (1 + rng.uniform(-1e-6, 1e-6, m))
    opacity[sel, 0] = np.log(p / (1 - p))
    sel = slice(4 * m, 5 * m)  # SH colour 0 exactly, one step below, one above
    c0 = np.float32(sh_lib.SH_C0)
    steps = [np.float32(-0.5 / c0)]
    for _ in range(64):
        steps.append(np.nextafter(steps[-1], np.float32(np.inf)))
        steps.insert(0, np.nextafter(steps[0], np.float32(-np.inf)))
    colour = [np.float32(c0 * v) + np.float32(0.5) for v in steps]  # ascending in v
    exact = [v for v, c in zip(steps, colour) if c == 0]
    negative = [v for v, c in zip(steps, colour) if c < 0]
    positive = [v for v, c in zip(steps, colour) if c > 0]
    if not (exact and negative and positive):
        raise ValueError(f"features_dc around {steps[64]}: SH colours "
                         f"{sorted(set(float(c) for c in colour))} miss 0 or a side of it")
    # the colour exactly 0, and the nearest float32 colours below and above it
    choice = np.array([exact[0], negative[-1], positive[0]], np.float32)
    dc[sel] = choice[rng.integers(0, 3, (m, 1, 3))]
    rest[sel] = 0.0
    scaling[5 * m:] = np.log(rng.uniform(0.001, 0.02, (m, 3)))  # radii of a few px
    params = SimpleNamespace(**{k_: torch.as_tensor(np.asarray(v, np.float32), device=device)
                                for k_, v in (("xyz", xyz), ("scaling", scaling),
                                              ("rotation", rotation), ("opacity", opacity),
                                              ("features_dc", dc), ("features_rest", rest))})
    alive = torch.ones(n, dtype=torch.bool, device=device)
    alive[::dead_every] = False
    kind = np.repeat(np.arange(nk), m)
    return params, alive, kind
