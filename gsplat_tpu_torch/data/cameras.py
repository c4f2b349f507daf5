"""Host-side camera/image loading: resolution policy, alpha, depth maps.

Counterpart of `gsplat_tpu/data/cameras.py` (reference
`utils/camera_utils.py:20-75` + `scene/cameras.py:19-89`). Images stay numpy
HWC float32 on the host; the camera is the port's `Camera` on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from PIL import Image

from gsplat_tpu_torch.convert import camera_from_numpy
from gsplat_tpu_torch.core.types import Camera
from gsplat_tpu_torch.data.readers import CameraInfo
from gsplat_tpu_torch.utils.graphics import fov2focal, projection_matrix, world_to_view


def _resolution(orig_w, orig_h, resolution, resolution_scale):
    """The -1 -> cap-1600px-wide policy (`camera_utils.py:43-63`)."""
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


@dataclass
class LoadedCamera:
    """A view with its ground-truth pixels."""

    camera: Camera
    image: np.ndarray  # (H, W, 3) float32 in [0, 1]
    alpha_mask: np.ndarray  # (H, W, 1) float32
    invdepth: np.ndarray | None  # (H, W) float32 or None
    depth_mask: np.ndarray | None  # (H, W, 1) float32 or None
    image_name: str
    uid: int
    depth_reliable: bool
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float

    @property
    def width(self) -> int:
        return self.camera.width

    @property
    def height(self) -> int:
        return self.camera.height


def make_camera(
    R, T, fovx, fovy, width, height, trans=None, scale=1.0,
    znear=0.01, zfar=100.0, device="cuda",
) -> Camera:
    """The port's Camera from reference-convention (R, T)."""
    w2v = world_to_view(R, T, trans, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full = (proj @ w2v).astype(np.float32)
    cam_center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)
    return camera_from_numpy(
        w2v, full, cam_center, np.tan(fovx * 0.5), np.tan(fovy * 0.5),
        width, height, device,
    )


def load_camera(
    info: CameraInfo,
    uid: int,
    resolution=-1,
    resolution_scale=1.0,
    trans=None,
    scale=1.0,
    is_nerf_synthetic=False,
    is_test_dataset=False,
    train_test_exp=False,
    white_background=False,
    device="cuda",
) -> LoadedCamera:
    """Load one view (the loadCam + Camera.__init__ pipeline); the camera is
    built on `device`."""
    with Image.open(info.image_path) as pil_img:
        orig_w, orig_h = pil_img.size
        w, h = _resolution(orig_w, orig_h, resolution, resolution_scale)
        pil_img = pil_img.resize((w, h), Image.LANCZOS if (w, h) != (orig_w, orig_h) else Image.NEAREST)
        arr = np.asarray(pil_img, dtype=np.float32) / 255.0

    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 4:
        alpha = arr[:, :, 3:4]
        if is_nerf_synthetic:
            # Blender: RGBA composited onto the background, alpha not a mask
            bg = np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
            rgb = arr[:, :, :3] * alpha + bg * (1.0 - alpha)
            alpha_mask = np.ones((h, w, 1), np.float32)
        else:
            rgb = arr[:, :, :3]
            alpha_mask = alpha.copy()
    else:
        rgb = arr[:, :, :3]
        alpha_mask = np.ones((h, w, 1), np.float32)

    # train_test_exp half-image masking (`cameras.py:50-54`)
    if train_test_exp and info.is_test:
        if is_test_dataset:
            alpha_mask[:, : w // 2] = 0
        else:
            alpha_mask[:, w // 2 :] = 0

    invdepth = None
    depth_mask = None
    depth_reliable = False
    if info.depth_path != "":
        with Image.open(info.depth_path) as dimg:
            draw = np.asarray(dimg, dtype=np.float32)
        draw = draw / 512.0 if is_nerf_synthetic else draw / float(2**16)
        if draw.ndim == 3:
            draw = draw[..., 0]
        dimg_pil = Image.fromarray(draw)
        invdepth = np.asarray(dimg_pil.resize((w, h), Image.BILINEAR), np.float32)
        invdepth = np.maximum(invdepth, 0.0)
        depth_mask = np.ones_like(alpha_mask)
        depth_reliable = True
        dp = info.depth_params
        if dp is not None:
            if dp["scale"] < 0.2 * dp["med_scale"] or dp["scale"] > 5 * dp["med_scale"]:
                depth_reliable = False
                depth_mask *= 0
            if dp["scale"] > 0:
                invdepth = invdepth * dp["scale"] + dp["offset"]

    camera = make_camera(
        info.R, info.T, info.fovx, info.fovy, w, h, trans=trans, scale=scale,
        device=device,
    )
    return LoadedCamera(
        camera=camera,
        image=np.clip(rgb, 0.0, 1.0),
        alpha_mask=alpha_mask,
        invdepth=invdepth,
        depth_mask=depth_mask,
        image_name=info.image_name,
        uid=uid,
        depth_reliable=depth_reliable,
        colmap_id=info.uid,
        R=info.R,
        T=info.T,
        fovx=info.fovx,
        fovy=info.fovy,
    )


def camera_to_json(uid, cam: LoadedCamera) -> dict:
    """Viewer-compatible cameras.json entry (`camera_utils.py:77-96`)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    w2c = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
