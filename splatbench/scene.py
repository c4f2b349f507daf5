"""The inputs of a run, made from `--seed`: the scene's parameters, the
cameras and the ground truth, on the device, in a few large calls.

The scene draws `tiny_scene`'s distributions (`gsplat_tpu_torch/synthetic.py`,
copied here with the seed taken from the run): xyz ~ N(0, 1), DC colour
~ N(0, 0.3), higher SH ~ N(0, 0.02), log-scales = log U(0.002, 0.012),
rotations and opacity logits ~ N(0, 1); every row alive. Cameras look at
the origin from `camera_distance`, with a horizontal fov of `fov_x` and
square pixels. Training views lie on a Fibonacci sphere; a render orbit is
a circle at a fixed elevation. A train step's other targets (alpha mask,
inverse depth and its mask) are planes the mix states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one of the run's independent draws (any size of `seed`)."""
    return (int(seed) * 16 + stream) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def make_params(config, seed, device):
    """{field: tensor} of the config's scene, drawn on `device`."""
    n, s = config["gaussians"], config["scene"]
    k = (config["sh_degree"] + 1) ** 2
    gen = generator(seed, 0, device)
    normal = torch.randn((n, 3 + 3 * k + 4 + 1), generator=gen, device=device)
    uniform = torch.rand((n, 3), generator=gen, device=device)
    lo, hi = s["scale_min"], s["scale_max"]
    params = {
        "xyz": normal[:, 0:3] * s["xyz_std"],
        "features_dc": (normal[:, 3:6] * s["features_dc_std"]).reshape(n, 1, 3),
        "features_rest": (normal[:, 6:3 * k + 3] * s["features_rest_std"]).reshape(n, k - 1, 3),
        "scaling": torch.log(lo + (hi - lo) * uniform),
        "rotation": normal[:, 3 * k + 3:3 * k + 7] * s["rotation_std"],
        "opacity": normal[:, 3 * k + 7:3 * k + 8] * s["opacity_logit_std"],
    }
    return {f: params[f].contiguous() for f in FIELDS}


def look_at(direction, distance):
    """World->view 4x4 of a camera at distance * direction looking at the
    origin (view axes: x right, y down, z forward)."""
    z = -np.asarray(direction, np.float64)
    z /= np.linalg.norm(z)
    hint = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.99 else np.array([1.0, 0.0, 0.0])
    x = np.cross(hint, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z])
    wv = np.eye(4)
    wv[:3, :3] = rot
    wv[:3, 3] = -rot @ (distance * -z)
    return wv


def projection(fov_x, fov_y, znear=0.01, zfar=100.0):
    """OpenGL-style perspective with view z in w (`getProjectionMatrix`)."""
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / math.tan(fov_x / 2)
    p[1, 1] = 1.0 / math.tan(fov_y / 2)
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def sphere_directions(n):
    """n directions spread evenly over the sphere (Fibonacci lattice)."""
    i = np.arange(n) + 0.5
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(1.0 - y * y)
    phi = i * math.pi * (3.0 - math.sqrt(5.0))
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], 1)


def orbit_directions(n, elevation):
    theta = 2.0 * math.pi * np.arange(n) / n
    return np.stack([math.cos(elevation) * np.sin(theta), np.full(n, -math.sin(elevation)),
                     math.cos(elevation) * np.cos(theta)], 1)


def cameras(directions, width, height, fov_x, distance, device):
    """One camera dict of plain tensors per direction (the reference's form:
    world_view, full_proj, camera_center, tan_fovx, tan_fovy, width, height)."""
    fov_y = 2.0 * math.atan(math.tan(fov_x / 2) * height / width)
    proj = projection(fov_x, fov_y)
    out = []
    for d in directions:
        wv = look_at(d, distance)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        out.append({"world_view": f32(wv), "full_proj": f32(proj @ wv),
                    "camera_center": f32(np.linalg.inv(wv)[:3, 3]),
                    "tan_fovx": f32(math.tan(fov_x / 2)), "tan_fovy": f32(math.tan(fov_y / 2)),
                    "width": int(width), "height": int(height)})
    return out


def extent(cams):
    """The scene extent the loop scales the position learning rate by
    (`getNerfppNorm`: 1.1 x the largest camera distance from their mean)."""
    centres = np.stack([c["camera_center"].cpu().numpy().astype(np.float64) for c in cams])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max() * 1.1)


def ground_truth(views, width, height, seed, device):
    """(views, H, W, 3) float32 images in [0, 1], on `device`."""
    gen = generator(seed, 1, device)
    return torch.rand((views, height, width, 3), generator=gen, device=device)


# the train step's target planes: (seed stream, trailing dimensions)
TARGETS = {"alpha_mask": (5, (1,)), "inverse_depth": (6, ()), "depth_mask": (7, ())}


def targets(stated, width, height, seed, device):
    """{name: plane} of the train step's targets as the mix states them: a
    number fills its plane, a pair [low, high] draws it uniformly from the
    seed. One plane per target serves every view."""
    out = {}
    for name, (stream, trail) in TARGETS.items():
        value, shape = stated[name], (height, width) + trail
        if isinstance(value, (int, float)):
            out[name] = torch.full(shape, float(value), device=device)
        else:
            low, high = value
            gen = generator(seed, stream, device)
            out[name] = low + (high - low) * torch.rand(shape, generator=gen, device=device)
    return out
