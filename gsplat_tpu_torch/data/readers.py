"""Scene-info readers: COLMAP and Blender (NeRF-synthetic) dataset layouts.

Counterpart of `gsplat_tpu/data/readers.py` (reference
`scene/dataset_readers.py:145-315`): the same eval splits (llffhold=8 or
test.txt), the same depth_params.json handling with med_scale, the same
nerf++ normalization, the same random-100k-point init for synthetic scenes
and the same camera-convention bridge (COLMAP qvec/tvec, or Blender c2w with
the OpenGL -> COLMAP axis flip). COLMAP models are read through the port's
`data/colmap.py`, the binary files by its native library when it builds.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gsplat_tpu_torch.core.sh import sh_to_rgb
from gsplat_tpu_torch.data import colmap as colmap_io
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


def _load_depth_params(path: str, depths: str) -> dict | None:
    """depth_params.json with the med_scale augmentation
    (`dataset_readers.py:157-177`). Raises if depths requested but file absent."""
    if depths == "":
        return None
    params_file = os.path.join(path, "sparse/0", "depth_params.json")
    try:
        with open(params_file) as f:
            depths_params = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"depth_params.json not found at '{params_file}' (required when --depths is set)"
        )
    all_scales = np.array([depths_params[k]["scale"] for k in depths_params])
    med_scale = float(np.median(all_scales[all_scales > 0])) if (all_scales > 0).sum() else 0
    for k in depths_params:
        depths_params[k]["med_scale"] = med_scale
    return depths_params


def read_colmap_scene_info(
    path, images=None, depths="", eval=False, train_test_exp=False, llffhold=8
) -> SceneInfo:
    """A COLMAP layout (`sparse/0` binary or text model, `images/`) ->
    SceneInfo (`dataset_readers.py:179-226`). Writes `sparse/0/points3D.ply`
    from the model's points on the first read and reads that file after."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap_io.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap_io.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap_io.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap_io.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    depths_params = _load_depth_params(path, depths)

    if eval:
        if llffhold:
            names = sorted(extr[k].name for k in extr)
            test_names = {nm for i, nm in enumerate(names) if i % llffhold == 0}
        else:
            with open(os.path.join(sparse, "test.txt")) as f:
                test_names = {line.strip() for line in f}
    else:
        test_names = set()

    reading_dir = "images" if images is None else images
    depths_dir = os.path.join(path, depths) if depths != "" else ""

    cam_infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(cam.params[0], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        elif cam.model == "PINHOLE":
            fovy = focal2fov(cam.params[1], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        else:
            raise ValueError(
                f"Colmap camera model {cam.model} not handled: only undistorted "
                "(PINHOLE / SIMPLE_PINHOLE) datasets are supported"
            )
        stem = im.name[: -(len(im.name.split(".")[-1]) + 1)]
        depth_params = None
        if depths_params is not None:
            depth_params = depths_params.get(stem)
            if depth_params is None:
                print(f"{key} not found in depths_params", file=sys.stderr)
        cam_infos.append(
            CameraInfo(
                uid=cam.id,
                R=np.transpose(colmap_io.qvec2rotmat(im.qvec)),
                T=np.array(im.tvec),
                fovy=fovy,
                fovx=fovx,
                image_path=os.path.join(path, reading_dir, im.name),
                image_name=im.name,
                width=cam.width,
                height=cam.height,
                is_test=im.name in test_names,
                depth_path=os.path.join(depths_dir, f"{stem}.png") if depths_dir else "",
                depth_params=depth_params,
            )
        )
    cam_infos.sort(key=lambda c: c.image_name)

    train_cams = [c for c in cam_infos if train_test_exp or not c.is_test]
    test_cams = [c for c in cam_infos if c.is_test]

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap_io.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap_io.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        ply_io.write_point_cloud(ply_path, xyz, rgb)
    points, colors, normals = ply_io.read_point_cloud(ply_path)

    return SceneInfo(
        points=points,
        colors=colors,
        normals=normals,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=nerfpp_norm(train_cams),
        ply_path=ply_path,
        is_nerf_synthetic=False,
    )


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
        kw.pop("white_background", None)
        kw.pop("extension", None)
        return read_colmap_scene_info(path, **kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        for k in ("images", "train_test_exp", "llffhold"):
            kw.pop(k, None)
        return read_blender_scene_info(path, **kw)
    raise ValueError(f"Could not recognize scene type at {path} (no sparse/ or transforms_train.json)")
