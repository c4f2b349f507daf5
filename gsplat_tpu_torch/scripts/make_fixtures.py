"""Deterministic fixture scenes: counterpart of `scripts/make_fixtures.py`.

    python -m gsplat_tpu_torch.scripts.make_fixtures --out tests/fixtures [--colmap]

The one- and two-gaussian snapshots (hand-picked parameters in the model
snapshot layout), the disc-splat COLMAP scene and the gaussian-GT COLMAP
scene that the quality run trains on (`colmap_proxy.py`). Every numpy draw
comes in the JAX script's order from the same seed, so the arrays, the PLY
files, the COLMAP `.bin` files and the disc-splat PNGs are the JAX
script's byte for byte. The gaussian-GT scene's images are rendered through
the port's `render()` (float32 packets) on `device`, the card unless the
caller asks for the CPU; they agree with the JAX script's within one uint8
level. Nothing here switches a process-wide device.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from gsplat_tpu_torch.core.sh import rgb_to_sh
from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.data.colmap import rotmat2qvec


def single_gaussian():
    xyz = np.array([[0.0, 0.0, 0.0]], np.float32)
    f_dc = rgb_to_sh(np.array([[[1.0, 0.2, 0.2]]], np.float32))
    f_rest = np.zeros((1, 15, 3), np.float32)
    opacity = np.array([[4.0]], np.float32)  # sigmoid -> 0.982
    scaling = np.log(np.array([[0.5, 0.25, 0.125]], np.float32))
    rotation = np.array([[0.924, 0.0, 0.383, 0.0]], np.float32)  # 45 deg about y
    return xyz, f_dc, f_rest, opacity, scaling, rotation


def two_gaussians():
    xyz = np.array([[-0.5, 0.0, 0.0], [0.5, 0.1, 0.6]], np.float32)
    f_dc = rgb_to_sh(np.array([[[0.2, 0.9, 0.2]], [[0.2, 0.2, 0.9]]], np.float32))
    f_rest = np.zeros((2, 15, 3), np.float32)
    opacity = np.array([[2.0], [1.0]], np.float32)
    scaling = np.log(np.array([[0.4, 0.4, 0.2], [0.3, 0.5, 0.25]], np.float32))
    rotation = np.array([[1.0, 0.0, 0.0, 0.0], [0.924, 0.383, 0.0, 0.0]], np.float32)
    return xyz, f_dc, f_rest, opacity, scaling, rotation


def _scene_dirs(out_dir):
    sparse = os.path.join(out_dir, "sparse", "0")
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)
    return sparse, images_dir


def _write_pinhole(sparse, width, height, focal):
    """cameras.bin: one PINHOLE camera (model id 1) with its principal
    point at the image centre."""
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))
        f.write(struct.pack("<dddd", focal, focal, width / 2.0, height / 2.0))


def _look_at_origin(p):
    """World -> camera rotation rows and translation of a camera at `p`
    looking at the origin, world z up."""
    z = -p / np.linalg.norm(p)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ p


def _write_images(sparse, poses):
    """images.bin: view i is `r_{i:03d}.png` on camera 1, no 2D points."""
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (R, t) in enumerate(poses):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<7d", *rotmat2qvec(R), *t))
            f.write(struct.pack("<i", 1))
            f.write(f"r_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def _write_points(sparse, pts, colors):
    """points3D.bin: error 0.5, empty tracks."""
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid in range(len(pts)):
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<3d", *pts[pid]))
            f.write(bytes(colors[pid]))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))


def make_colmap_scene(out_dir: str, n_points: int = 300, n_images: int = 12, width: int = 96,
                      height: int = 64, focal: float = 100.0, seed: int = 0):
    """A tiny synthetic COLMAP scene (`sparse/0/*.bin` + `images/*.png`):
    one PINHOLE camera, a ring of views looking at the origin, a coloured
    point cloud in a unit ball, and ground-truth PNGs painted from those
    points by a z-buffered disc splatter (far to near). Enough signal for a
    short training run to lower its loss; not 3D-consistent imagery."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sparse, images_dir = _scene_dirs(out_dir)

    pts = rng.normal(0, 0.45, (n_points, 3))
    pts = pts[np.argsort(pts[:, 2])]  # a stable draw order for the splatter
    colors = (np.clip(pts * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    _write_pinhole(sparse, width, height, focal)
    poses = []
    for i in range(n_images):
        ang = 2 * np.pi * i / n_images
        poses.append(_look_at_origin(np.array([4.0 * np.cos(ang), 4.0 * np.sin(ang), 1.2])))
    _write_images(sparse, poses)
    _write_points(sparse, pts, colors)

    cx, cy = width / 2.0, height / 2.0
    yy, xx = np.mgrid[-2:3, -2:3]
    disc = (yy * yy + xx * xx) <= 4
    for i, (R, t) in enumerate(poses):
        cam = pts @ R.T + t
        img = np.zeros((height, width, 3), np.uint8)
        for j in np.argsort(-cam[:, 2]):
            X, Y, Z = cam[j]
            if Z <= 0.2:
                continue
            u = int(round(focal * X / Z + cx))
            v = int(round(focal * Y / Z + cy))
            for dy, dx in zip(*np.nonzero(disc)):
                py, px = v + dy - 2, u + dx - 2
                if 0 <= py < height and 0 <= px < width:
                    img[py, px] = colors[j]
        Image.fromarray(img).save(os.path.join(images_dir, f"r_{i:03d}.png"))
    return out_dir


def gaussian_gt_cloud(n_gauss: int, rng: np.random.Generator):
    """The ground-truth cloud of `make_colmap_gaussian_scene`, drawn from
    `rng` in the generator's order: smooth, opaque-ish blobs in a unit ball
    with view-independent colour. Returns (params dict of float64 arrays,
    colour (n, 3))."""
    xyz = rng.normal(0, 0.45, (n_gauss, 3))
    log_scaling = np.log(rng.uniform(0.015, 0.09, (n_gauss, 3)))
    rotation = rng.normal(size=(n_gauss, 4))
    rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
    logit_opacity = rng.uniform(0.5, 3.0, (n_gauss, 1))
    color = np.clip(xyz * 0.5 + 0.5 + rng.normal(0, 0.08, (n_gauss, 3)), 0, 1)
    params = {"xyz": xyz, "features_dc": rgb_to_sh(color)[:, None, :],
              "features_rest": np.zeros((n_gauss, 15, 3)), "scaling": log_scaling,
              "rotation": rotation, "opacity": logit_opacity}
    return params, color


def gt_render_settings():
    """What the ground truth is rendered with: SH degree 3, float32
    packets (the JAX generator's `backend="jnp"` path is float32)."""
    from gsplat_tpu_torch.core.types import make_render_settings

    return make_render_settings(sh_degree=3, packet_dtype="float32")


def make_colmap_gaussian_scene(out_dir: str, n_gauss: int = 4096, n_points: int = 2048,
                               n_images: int = 64, width: int = 400, height: int = 304,
                               focal: float = 380.0, seed: int = 3, device=None):
    """A synthetic COLMAP scene whose ground truth is a gaussian render.

    The COLMAP model is written first (one PINHOLE camera, a ring of views
    at varying heights), then the scene is loaded back through the port's
    own reader (`data/scene.py`, unshuffled) and each loaded view is
    rendered from the known cloud on a black background, so the pose
    conventions are certified round trip and the scene lies inside the
    model class. `points3D.bin` is an SfM-like noisy subset of the
    gaussian centres, the trainer's init. The first read writes
    `sparse/0/points3D.ply` beside the bins, as every read of a COLMAP
    scene does. `device` is where the views render (`None`: the card).
    """
    from PIL import Image

    from gsplat_tpu_torch.convert import params_from_numpy
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.render import render

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sparse, images_dir = _scene_dirs(out_dir)
    params, color = gaussian_gt_cloud(n_gauss, rng)

    _write_pinhole(sparse, width, height, focal)
    poses = []
    for i in range(n_images):
        ang = 2 * np.pi * i / n_images
        elev = 0.6 + 0.8 * ((i * 7) % n_images) / n_images  # vary the height
        poses.append(_look_at_origin(np.array([3.5 * np.cos(ang), 3.5 * np.sin(ang), elev])))
    _write_images(sparse, poses)

    sel = rng.choice(n_gauss, size=min(n_points, n_gauss), replace=False)
    pts = params["xyz"][sel] + rng.normal(0, 0.01, (len(sel), 3))
    _write_points(sparse, pts, (color[sel] * 255).astype(np.uint8))

    # placeholder images so the reader can build the camera list
    blank = Image.fromarray(np.zeros((height, width, 3), np.uint8))
    for i in range(n_images):
        blank.save(os.path.join(images_dir, f"r_{i:03d}.png"))

    import torch

    scene = load_scene(out_dir, dev)
    gparams = params_from_numpy(params, dev)
    alive = torch.ones(n_gauss, dtype=torch.bool, device=dev)
    settings = gt_render_settings()
    for holder in scene.get_train_cameras():
        with torch.no_grad():
            img = render(holder.camera, gparams, alive, settings, [0.0, 0.0, 0.0],
                         device=dev)["render"].cpu().numpy()
        img8 = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        name = holder.image_name if holder.image_name.endswith(".png") else holder.image_name + ".png"
        Image.fromarray(img8).save(os.path.join(images_dir, name))
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description="write the fixture scenes")
    parser.add_argument("--out", default="tests/fixtures")
    parser.add_argument("--colmap", action="store_true",
                        help="also write the synthetic COLMAP scene under <out>/colmap_scene")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    ply_io.save_gaussian_ply(os.path.join(args.out, "single_gaussian.ply"), *single_gaussian())
    ply_io.save_gaussian_ply(os.path.join(args.out, "two_gaussians.ply"), *two_gaussians())
    if args.colmap:
        make_colmap_scene(os.path.join(args.out, "colmap_scene"))
    print(f"wrote fixtures to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
