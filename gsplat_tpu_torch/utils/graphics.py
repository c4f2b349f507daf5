"""Camera matrix construction (numpy, data-loading side).

Same conventions as the reference (`utils/graphics_utils.py:31-77`), but the
matrices handed to the renderer are kept in plain math form: `world_view` maps
world->camera via ``x_cam = world_view @ [x, 1]``; the reference stores the
transposes (glm row-vector convention, `scene/cameras.py:86-89`) and its CUDA
kernels read them back column-first, which is the same math.
"""

from __future__ import annotations

import math

import numpy as np


def world_to_view(R, t, translate=None, scale=1.0):
    """World->camera 4x4 from COLMAP-style (R, t).

    `R` is camera->world rotation (transposed on assembly, matching
    `getWorld2View2`, `utils/graphics_utils.py:38-49`); `translate`/`scale`
    re-center and re-scale the camera path (used by the nerf++ normalization).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear, zfar, fov_x, fov_y):
    """OpenGL-style perspective with z_sign=+1 (`graphics_utils.py:51-71`).

    Maps view-space z to [0, zfar/(zfar-znear)]-ish NDC depth and puts view z
    in w (P[3,2]=1), so after the w-divide the rasterizer's p_proj.z is a
    nonlinear depth and p_w is the view depth.
    """
    tan_y = math.tan(fov_y / 2)
    tan_x = math.tan(fov_x / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))
