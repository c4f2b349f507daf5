"""Port `preprocess` vs the JAX package on the `make_test_scene` scenes.

Float fields at rtol 1e-5 / atol 1e-5 (the same float32 expressions, with
transcendentals from two libraries); radius, tile rects, tiles touched and
the survivor mask exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsplat_tpu.core.types import make_render_settings as j_settings
from gsplat_tpu.ops.projection import preprocess as j_preprocess
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.convert import camera_from_numpy, params_from_numpy
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.ops.projection import preprocess as t_preprocess
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs

EXACT = ("radius", "rect_min", "rect_max", "tiles_touched", "mask")
FLOATS = ("mean2d", "conic", "opacity", "rgb", "depth", "cull_qmax")


def port_inputs(params, camera, alive, device="cpu"):
    """JAX (params, camera, alive) -> the port's, through numpy."""
    p = params_from_numpy({f: np.asarray(getattr(params, f)) for f in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")}, device)
    c = camera_from_numpy(
        np.asarray(camera.world_view), np.asarray(camera.full_proj),
        np.asarray(camera.camera_center), np.asarray(camera.tan_fovx),
        np.asarray(camera.tan_fovy), camera.width, camera.height, device,
    )
    return p, c, torch.tensor(np.asarray(alive), device=device)


def both_screens(seed, n, width, height, sh_degree, antialiasing, tight_cull):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width,
                         height=height, sh_degree=sh_degree)
    params, camera, alive = scene_to_inputs(sc)
    alive = alive.at[::7].set(False)  # some dead rows
    gx, gy = grid_dims(camera, 16)
    kw = dict(sh_degree=sh_degree, antialiasing=antialiasing, tight_cull=tight_cull)
    js = j_preprocess(params, alive, camera, j_settings(**kw), gx, gy)
    tp, tc, ta = port_inputs(params, camera, alive)
    with torch.no_grad():
        ts = t_preprocess(tp, ta, tc, t_settings(**kw), gx, gy)
    return js, ts


@pytest.mark.parametrize("antialiasing", [False, True])
@pytest.mark.parametrize("tight_cull", [True, False])
def test_preprocess_matches_jax(antialiasing, tight_cull):
    js, ts = both_screens(5, 600, 160, 112, 3, antialiasing, tight_cull)
    assert int(np.asarray(js.mask).sum()) > 100
    for f in EXACT:
        np.testing.assert_array_equal(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f
        )
    for f in FLOATS:
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
            rtol=1e-5, atol=1e-5, err_msg=f,
        )
    assert {f.name for f in dataclasses.fields(ts)} == set(EXACT + FLOATS)


def test_preprocess_is_differentiable():
    sc =make_test_scene(np.random.default_rng(2), n=50, sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    tp, tc, ta = port_inputs(params, camera, alive)
    ts = t_preprocess(tp, ta, tc, t_settings(sh_degree=1), 4, 3)
    (ts.mean2d.sum() + ts.rgb.sum() + ts.opacity.sum() + ts.conic.sum()).backward()
    for name in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        g = getattr(tp, name).grad
        assert g is not None and torch.isfinite(g).all(), name
