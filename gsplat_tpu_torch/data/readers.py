"""Scene-info readers: the Blender (NeRF-synthetic) layout.

Counterpart of `gsplat_tpu/data/readers.py` (`read_blender_scene_info`,
`:222-257`), same splits, the same random-100k-point init for synthetic
scenes and the same OpenGL -> COLMAP axis flip. COLMAP scenes are read by the
data slice of the port (with `data/colmap.py`); until then
`read_scene_info` refuses them with an error that says so.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gsplat_tpu_torch.core.sh import sh_to_rgb
from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.utils.graphics import focal2fov, fov2focal, world_to_view


@dataclass(frozen=True)
class CameraInfo:
    """Per-view metadata before image loading (reference `dataset_readers.py:26-38`)."""

    uid: int
    R: np.ndarray  # (3,3) cam->world rotation (transposed w2c, glm convention)
    T: np.ndarray  # (3,) w2c translation
    fovy: float
    fovx: float
    image_path: str
    image_name: str
    width: int
    height: int
    is_test: bool = False
    depth_path: str = ""
    depth_params: dict | None = None


@dataclass
class SceneInfo:
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    normals: np.ndarray
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool


def nerfpp_norm(cam_infos) -> dict:
    """Camera-extent normalization (`dataset_readers.py:48-69`)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diagonal * 1.1)}


def _read_transforms(path, transformsfile, depths_dir, is_test, extension=".png"):
    """Blender transforms_*.json -> CameraInfos (`dataset_readers.py:228-271`)."""
    from PIL import Image

    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cam_infos = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"] + extension
        image_path = os.path.join(path, file_path)
        image_name = Path(file_path).stem

        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        with Image.open(image_path) as img:
            width, height = img.size
        fovy = focal2fov(fov2focal(fovx, width), height)
        cam_infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fovy=fovy,
                fovx=fovx,
                image_path=image_path,
                image_name=image_name,
                width=width,
                height=height,
                is_test=is_test,
                depth_path=os.path.join(depths_dir, f"{image_name}.png") if depths_dir else "",
            )
        )
    return cam_infos


def read_blender_scene_info(path, white_background=False, depths="", eval=False, extension=".png") -> SceneInfo:
    depths_dir = os.path.join(path, depths) if depths != "" else ""
    train_cams = _read_transforms(path, "transforms_train.json", depths_dir, False, extension)
    test_cams = _read_transforms(path, "transforms_test.json", depths_dir, True, extension)
    if not eval:
        train_cams = train_cams + test_cams
        test_cams = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # no SfM points for synthetic scenes: random init inside the scene
        # bounds, like `dataset_readers.py:288-298`
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        try:
            ply_io.write_point_cloud(ply_path, xyz, sh_to_rgb(shs) * 255)
        except (PermissionError, OSError):
            ply_path = ""  # read-only dataset dir; keep the in-memory cloud
        points, colors = xyz.astype(np.float32), np.asarray(sh_to_rgb(shs), np.float32)
        normals = np.zeros_like(points)
    else:
        points, colors, normals = ply_io.read_point_cloud(ply_path)

    return SceneInfo(
        points=points,
        colors=colors,
        normals=normals,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=nerfpp_norm(train_cams),
        ply_path=ply_path,
        is_nerf_synthetic=True,
    )


def read_scene_info(path, **kw) -> SceneInfo:
    """Dataset-type dispatch (`scene/__init__.py:43-49`)."""
    if os.path.exists(os.path.join(path, "sparse")):
        raise NotImplementedError(
            f"{path} is a COLMAP scene: gsplat_tpu_torch reads COLMAP scenes "
            "from its data slice on (data/colmap.py is not ported yet); "
            "Blender-format scenes are supported"
        )
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        for k in ("images", "train_test_exp", "llffhold"):
            kw.pop(k, None)
        return read_blender_scene_info(path, **kw)
    raise ValueError(f"Could not recognize scene type at {path} (no sparse/ or transforms_train.json)")
