"""Scene container: dataset dispatch, camera lists, model snapshots.

Counterpart of `gsplat_tpu/data/scene.py`. The Scene owns the data side
(cameras, initial point cloud, extent) and snapshot IO; the model itself is
a dict of tensors. With `model_path` it copies the input point cloud to
`input.ply`, writes `cameras.json`, and `save` writes reference-layout
snapshots (`point_cloud/iteration_<n>/point_cloud.ply` + `exposure.json`)
that the port's render CLI and the JAX package's `load_snapshot` both read.
"""

from __future__ import annotations

import json
import os
import random
import shutil

import numpy as np

from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.data.cameras import LoadedCamera, camera_to_json, load_camera
from gsplat_tpu_torch.data.readers import read_scene_info


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str | None = None,
        images: str | None = None,
        depths: str = "",
        resolution: int = -1,
        white_background: bool = False,
        eval: bool = False,
        train_test_exp: bool = False,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        seed: int = 0,
        device="cuda",
    ):
        self.source_path = source_path
        self.model_path = model_path
        self.train_test_exp = train_test_exp

        info = read_scene_info(
            source_path,
            images=images,
            depths=depths,
            eval=eval,
            train_test_exp=train_test_exp,
            white_background=white_background,
        )
        self.info = info
        self.cameras_extent = info.nerf_normalization["radius"]
        self.is_nerf_synthetic = info.is_nerf_synthetic

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            if info.ply_path and os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            # fixed-seed camera shuffle like `scene/__init__.py:65-67`
            random.Random(seed).shuffle(train_infos)
            random.Random(seed).shuffle(test_infos)

        def load_all(infos, is_test):
            return [
                load_camera(
                    ci, uid=i, resolution=resolution, resolution_scale=scale,
                    is_nerf_synthetic=info.is_nerf_synthetic, is_test_dataset=is_test,
                    train_test_exp=train_test_exp, white_background=white_background,
                    device=device,
                )
                for i, ci in enumerate(infos)
            ]

        self.train_cameras: dict[float, list[LoadedCamera]] = {}
        self.test_cameras: dict[float, list[LoadedCamera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = load_all(train_infos, False)
            self.test_cameras[scale] = load_all(test_infos, True)

        if model_path:
            cams = self.train_cameras.get(1.0, []) + self.test_cameras.get(1.0, [])
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(c.uid, c) for c in cams], f)

    def get_train_cameras(self, scale: float = 1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0):
        return self.test_cameras[scale]

    def save(self, iteration: int, params, alive, exposure=None, image_names=None):
        """Model snapshot of the live rows: reference-layout PLY +
        exposure.json (`scene/__init__.py:85-94`). `params` maps field
        names to (C, ...) tensors or arrays."""
        if not self.model_path:
            raise ValueError("Scene needs model_path to save snapshots")
        pc_dir = os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")
        os.makedirs(pc_dir, exist_ok=True)
        keep = _host(alive).astype(bool)
        p = {k: _host(params[k])[keep] for k in (
            "xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")}
        ply_io.save_gaussian_ply(
            os.path.join(pc_dir, "point_cloud.ply"),
            p["xyz"], p["features_dc"], p["features_rest"], p["opacity"], p["scaling"],
            p["rotation"],
        )
        if exposure is not None:
            names = image_names or [c.image_name for c in self.get_train_cameras()]
            exp = _host(exposure)
            mapping = {nm: exp[i].tolist() for i, nm in enumerate(names[: exp.shape[0]])}
            with open(os.path.join(self.model_path, "exposure.json"), "w") as f:
                json.dump(mapping, f, indent=2)


def load_scene(source_path: str, device="cuda", eval: bool = False,
               white_background: bool = False) -> Scene:
    """A scene's cameras at full resolution in file order, with no model
    directory: the loader of the fixture generator, the COLMAP quality run
    and the trained-cloud bench row."""
    return Scene(source_path, model_path=None, images="images", depths="", resolution=-1,
                 white_background=white_background, eval=eval, train_test_exp=False,
                 shuffle=False, device=device)
