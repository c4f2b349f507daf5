"""Core types: Gaussian parameters, camera, render settings.

Counterpart of `gsplat_tpu/core/types.py`. The parameters are an
`nn.Module` of six `nn.Parameter`s (the reference's own layout,
`scene/gaussian_model.py:54-66`); the camera and the settings are frozen
dataclasses with the JAX package's fields and defaults.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


class GaussianParams(nn.Module):
    """Learnable Gaussian parameters (pre-activation), shape-(capacity, ...).

    Same parameterization as the reference (`scene/gaussian_model.py:54-59`):
    log-scales, unnormalized wxyz quaternions, logit opacities, SH features
    split into the DC band and the rest.
    """

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation, opacity):
        super().__init__()
        self.xyz = nn.Parameter(torch.as_tensor(xyz))  # (N, 3) world positions
        self.features_dc = nn.Parameter(torch.as_tensor(features_dc))  # (N, 1, 3)
        self.features_rest = nn.Parameter(torch.as_tensor(features_rest))  # (N, K-1, 3)
        self.scaling = nn.Parameter(torch.as_tensor(scaling))  # (N, 3) log-scales
        self.rotation = nn.Parameter(torch.as_tensor(rotation))  # (N, 4) wxyz
        self.opacity = nn.Parameter(torch.as_tensor(opacity))  # (N, 1) logit

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.features_rest.shape[1]
        return int(round(k**0.5)) - 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single calibrated view, in the JAX package's math convention:
    ``x_cam = world_view @ [x, 1]`` and ``p_hom = full_proj @ [x, 1]``.

    The tensor fields are float32; `tan_fovx`/`tan_fovy` are 0-d tensors so
    the focal lengths round in float32 exactly as the JAX package's do.
    """

    world_view: torch.Tensor  # (4, 4) world -> camera
    full_proj: torch.Tensor  # (4, 4) projection @ world_view
    camera_center: torch.Tensor  # (3,) camera position in world space
    tan_fovx: torch.Tensor  # () scalar
    tan_fovy: torch.Tensor  # () scalar
    width: int = 0
    height: int = 0

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            camera_center=self.camera_center.to(device),
            tan_fovx=self.tan_fovx.to(device),
            tan_fovy=self.tan_fovy.to(device),
        )


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Rasterization configuration, with the JAX package's fields and defaults.

    `backend`, `chunk`, `max_per_tile` and `instance_capacity` exist only for
    XLA or the TPU (a static instance buffer, the jnp walk's per-tile cap, the
    Pallas/jnp switch). They are accepted so that `cfg_args` and JAX settings
    carry over, and have no effect here: the port sizes its instance buffer
    per frame and always renders through its CUDA kernels on a CUDA device.
    """

    scale_modifier: float = 1.0
    tile: int = 16
    instance_capacity: int = 1 << 18
    max_per_tile: int = 1024
    chunk: int = 128
    antialiasing: bool = False
    sh_degree: int = 3
    backend: str = "jnp"
    # "float32" (parity) | "hybrid" (conic, opacity, rgb rows and the
    # backward's gradient rows rounded to bf16; positions and invz exact) |
    # "bfloat16" (all ten rows and the gradient rows rounded to bf16)
    packet_dtype: str = "float32"
    # drop (gaussian, tile) instances whose max alpha over the tile is
    # provably < 1/255 (see ops/binning.compute_row_runs)
    tight_cull: bool = True
    # per-pixel 1-based index of the last blended instance
    track_contrib: bool = False
    # "sorted" (front-to-back, reference parity) | "oit" (order-independent
    # weighted sums, kernels K5' and K6')
    blend_mode: str = "sorted"


def make_render_settings(**kw) -> RenderSettings:
    return RenderSettings(**kw)
