"""Seeded synthetic scene: the port's copy of `__graft_entry__._tiny_scene`.

Same numpy seed and draws, so the same (n, capacity, sh_degree) gives the
same arrays as the JAX package's generator. At n = 1,048,576, SH degree 3
and 1920x1080 it is the repo's flagship garden-class scene. Also a table
of parameter rows that sit on the projection's edges
(`projection_edge_table`), and one of screen rows on the emission tables'
edges (`emission_edge_screen`).
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


EMISSION_EDGE_KINDS = ("plain", "rect_h_0_8_9", "det_le_0", "a_le_0", "c_le_0", "qmax_le_0",
                       "b_0", "tile_edge_centre", "dead", "whole_grid", "rect_w_0",
                       "nan_mean2d", "inf_mean2d", "nan_conic", "inf_conic")


def emission_edge_screen(n=3000, device="cuda", finite=False, seed=5):
    """Screen rows (`ScreenGaussians`) built to sit on the edges of the
    emission tables (`ops/binning.py:compute_row_runs` and its kernel Bt')
    on a 1920x1080 tile grid (120 x 68): each row draws a kind of
    `EMISSION_EDGE_KINDS` over a plain row (a rect of up to 12 x 10 tiles,
    its centre within half a tile of it, a positive-definite conic,
    cull_qmax in (0.1, 12)): rect heights of 0, 8 and 9 tiles; det exactly
    0 or just below; a and c at 0 or below; cull_qmax at 0 or below; b =
    +-0; centres on tile edges (16k, 16k + 15, 16k + 16 - 2^-8); dead rows
    (no tile); the whole grid (four rows); rect width 0 (a tile count of its height);
    NaN and +-inf in mean2d and in a conic entry (left out with `finite`).
    Returns (screen, kind of each row)."""
    from gsplat_tpu_torch.ops.projection import ScreenGaussians

    rng = np.random.default_rng(seed)
    gx, gy = 120, 68
    kinds = EMISSION_EDGE_KINDS[:11] if finite else EMISSION_EDGE_KINDS
    kind = rng.integers(0, len(kinds), n)
    whole_grid = kinds.index("whole_grid")  # 8,160 instances a row: four rows
    kind[kind == whole_grid] = 0
    kind[rng.choice(n, min(n, 4), replace=False)] = whole_grid
    is_ = {k: kind == i for i, k in enumerate(kinds)}
    rw = rng.integers(1, 13, n)
    rh = np.where(is_["rect_h_0_8_9"], rng.choice([0, 8, 9], n), rng.integers(1, 11, n))
    rw[is_["rect_w_0"]] = 0
    x0, y0 = rng.integers(0, gx - 12, n), rng.integers(0, gy - 10, n)
    whole = is_["whole_grid"]
    x0[whole], y0[whole], rw[whole], rh[whole] = 0, 0, gx, gy
    mx = 16.0 * (x0 + rng.uniform(-0.5, rw + 0.5))
    my = 16.0 * (y0 + rng.uniform(-0.5, rh + 0.5))
    edge = is_["tile_edge_centre"]
    off = rng.choice([0.0, 15.0, 16.0 - 2.0**-8], (2, n))
    mx[edge] = 16.0 * (x0 + rng.integers(0, np.maximum(rw, 1)))[edge] + off[0, edge]
    my[edge] = 16.0 * (y0 + rng.integers(0, np.maximum(rh, 1)))[edge] + off[1, edge]
    a, c = np.exp(rng.uniform(-7.0, 0.5, (2, n)))
    b = rng.uniform(-0.995, 0.995, n) * np.sqrt(a * c)
    qmax = rng.uniform(0.1, 12.0, n)
    sel = is_["det_le_0"]  # b = a = c (det exactly 0) or b just past sqrt(ac)
    zero_det = sel & (rng.random(n) < 0.5)
    a[zero_det] = c[zero_det] = b[zero_det] = a[zero_det]
    b[sel & ~zero_det] = np.sqrt(a * c)[sel & ~zero_det] * rng.choice([-1.0, 1.0]) * 1.001
    a[is_["a_le_0"]] = rng.choice([0.0, -0.0, -1e-3], is_["a_le_0"].sum())
    c[is_["c_le_0"]] = rng.choice([0.0, -1e-3], is_["c_le_0"].sum())
    qmax[is_["qmax_le_0"]] = rng.choice([0.0, -1.0], is_["qmax_le_0"].sum())
    b[is_["b_0"]] = rng.choice([0.0, -0.0], is_["b_0"].sum())
    conic = np.stack([a, b, c], 1).astype(np.float32)
    mean2d = np.stack([mx, my], 1).astype(np.float32)
    if not finite:  # one entry of the row's mean2d or conic
        for name, arr, values in (("nan_mean2d", mean2d, (np.nan,)),
                                  ("inf_mean2d", mean2d, (np.inf, -np.inf)),
                                  ("nan_conic", conic, (np.nan,)),
                                  ("inf_conic", conic, (np.inf, -np.inf))):
            sel = is_[name]
            col = rng.integers(0, arr.shape[1], n)
            arr[sel, col[sel]] = rng.choice(values, sel.sum())
    touched = rw * rh
    touched[is_["rect_w_0"]] = rh[is_["rect_w_0"]]  # the expand's width clamps to 1
    touched[is_["dead"]] = 0
    rect_min = np.stack([x0, y0], 1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    screen = ScreenGaussians(
        mean2d=f32(mean2d), conic=f32(conic), opacity=f32(rng.uniform(0.01, 1.0, n)),
        rgb=f32(rng.uniform(0.0, 1.0, (n, 3))), depth=f32(rng.uniform(0.3, 50.0, n)),
        radius=i32(np.zeros(n)), cull_qmax=f32(qmax), rect_min=i32(rect_min),
        rect_max=i32(rect_min + np.stack([rw, rh], 1)), tiles_touched=i32(touched),
        mask=torch.as_tensor(touched > 0, device=device))
    return screen, np.asarray(kinds)[kind]
