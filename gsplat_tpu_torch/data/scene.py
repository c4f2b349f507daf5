"""Read-only scene container: dataset dispatch and camera lists.

Counterpart of `gsplat_tpu/data/scene.py` for rendering. Writing model
snapshots (`model_path`) belongs to the training slice, so only
`model_path=None` is accepted.
"""

from __future__ import annotations

import random

from gsplat_tpu_torch.data.cameras import LoadedCamera, load_camera
from gsplat_tpu_torch.data.readers import read_scene_info


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
        if model_path:
            raise NotImplementedError(
                "Scene is read-only in gsplat_tpu_torch so far: writing model "
                "snapshots comes with the training slice (pass model_path=None)"
            )
        self.source_path = source_path
        self.model_path = None
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

    def get_train_cameras(self, scale: float = 1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0):
        return self.test_cameras[scale]
