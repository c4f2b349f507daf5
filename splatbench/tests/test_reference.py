"""The plain reference on a tiny scene: its work counts and image against a
pixel-by-pixel loop, and the reference against the port's plain twins
(projection, blend, composite, loss, Adam and the train step's gradient),
all on the CPU."""

from __future__ import annotations

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import scene  # noqa: E402
from splatbench.reference import render as ref  # noqa: E402
from splatbench.reference import train as ref_train  # noqa: E402

CONFIG = {"gaussians": 60, "sh_degree": 3,
          "scene": {"xyz_std": 0.5, "features_dc_std": 0.3, "features_rest_std": 0.02,
                    "scale_min": 0.02, "scale_max": 0.12, "rotation_std": 1.0,
                    "opacity_logit_std": 2.0}}


def tiny(seed, width=40, height=24):
    params = scene.make_params(CONFIG, seed, "cpu")
    cam = scene.cameras(scene.sphere_directions(3)[seed % 3:][:1], width, height, 0.9, 4.0,
                        "cpu")[0]
    return params, cam


def brute_force(params, cam):
    """Every pixel walks its tile's instances in depth order (float32 alpha,
    the transmittance as a float64 product): image, and the counts."""
    s = {k: v.detach() for k, v in ref.project(params, cam).items()}
    gx, gy = ref.grid(cam)
    w, h = cam["width"], cam["height"]
    per_tile = {t: [] for t in range(gx * gy)}
    for g in range(len(s["depth"])):
        if not s["valid"][g]:
            continue
        mx, my = s["mean2d"][g].tolist()
        r = float(s["radius"][g])
        x0, y0 = (min(max(math.floor((v - r) / 16), 0), n) for v, n in ((mx, gx), (my, gy)))
        x1, y1 = (min(max(math.floor((v + r + 15) / 16), 0), n) for v, n in ((mx, gx), (my, gy)))
        for ty in range(y0, y1):
            for tx in range(x0, x1):
                per_tile[ty * gx + tx].append(g)

    def alpha(g, px, py):
        d = s["mean2d"][g] - torch.tensor([px, py], dtype=torch.float32)
        a, b, c = s["conic"][g]
        power = -0.5 * (a * d[0] * d[0] + c * d[1] * d[1]) - b * d[0] * d[1]
        al = torch.clamp(s["opacity"][g] * torch.exp(power), max=0.99)
        return float(al) if power <= 0 and al >= 1 / 255 else 0.0

    image = np.zeros((h, w, 3))
    counts = {"instances": 0, "pairs": 0, "blended": 0}
    stopped = 0
    live = set()
    for t, gids in per_tile.items():
        gids = sorted(gids, key=lambda g: (float(s["depth"][g]), g))
        pixels = [(t % gx * 16 + i % 16, t // gx * 16 + i // 16) for i in range(256)]
        pixels = [(x, y) for x, y in pixels if x < w and y < h]
        gids = [g for g in gids if any(alpha(g, x, y) > 0 for x, y in pixels)]
        counts["instances"] += len(gids)
        live.update(gids)
        for x, y in pixels:
            T = 1.0
            for g in gids:
                counts["pairs"] += 1
                a = alpha(g, x, y)
                if a == 0.0:
                    continue
                if T * (1 - a) < 1e-4:
                    stopped += 1
                    break
                counts["blended"] += 1
                image[y, x] += a * T * s["rgb"][g].double().numpy()
                T *= 1 - a
    counts["live"] = len(live)
    counts["visible"] = int(s["valid"].sum())
    return np.clip(image, 0, 1), counts, stopped


@pytest.mark.parametrize("seed", [3, 4, 2**31 + 5])
def test_work_counts_equal_a_pixel_by_pixel_count(seed):
    params, cam = tiny(seed)
    got = ref.render(params, cam, torch.zeros(3), count=True)
    image, counts, _ = brute_force(params, cam)
    for k, v in counts.items():
        assert got["counts"][k] == v, k
    assert counts["blended"] > 0 and counts["pairs"] > counts["blended"]
    assert np.abs(got["render"].double().numpy() - image).max() < 1e-5


def test_the_pixel_loop_stops_pixels():
    """With opaque gaussians pixels stop before their tile's last instance,
    and the reference stops them where the loop does."""
    params, cam = tiny(3)
    params["opacity"] = params["opacity"] + 6.0
    params["scaling"] = params["scaling"] + 1.0
    image, counts, stopped = brute_force(params, cam)
    got = ref.render(params, cam, torch.zeros(3), count=True)
    assert stopped > 0
    assert {k: got["counts"][k] for k in counts} == counts
    assert np.abs(got["render"].double().numpy() - image).max() < 1e-5


def test_chunks_cover_whole_tiles_in_order():
    tile = torch.tensor([0] * 5 + [1] * 3 + [4] * 9 + [7] * 2)
    saved = ref.ROWS_PER_CHUNK
    try:
        ref.ROWS_PER_CHUNK = 6
        bounds = ref._chunks(tile)
    finally:
        ref.ROWS_PER_CHUNK = saved
    assert bounds == [(0, 5), (5, 8), (8, 17), (17, 19)]


# --- the reference against the port's plain twins -------------------------

def port():
    from gsplat_tpu_torch.core.types import Camera, make_render_settings
    from gsplat_tpu_torch.render import render

    return Camera, make_render_settings, render


def port_camera(cam):
    Camera, _, _ = port()
    return Camera(world_view=cam["world_view"], full_proj=cam["full_proj"],
                  camera_center=cam["camera_center"], tan_fovx=cam["tan_fovx"],
                  tan_fovy=cam["tan_fovy"], width=cam["width"], height=cam["height"])


@pytest.mark.parametrize("seed", [7, 8])
def test_reference_render_equals_the_ports_plain_twins(seed):
    _, settings, render = port()
    params, cam = tiny(seed, 64, 48)
    alive = torch.ones(CONFIG["gaussians"], dtype=torch.bool)
    want = render(port_camera(cam), SimpleNamespace(**params), alive,
                  settings(sh_degree=3, packet_dtype="float32"), torch.zeros(3), device="cpu")
    got = ref.render(params, cam, torch.zeros(3))
    assert torch.allclose(got["render"], want["render"], atol=2e-6)
    assert torch.allclose(got["final_t"], want["final_t"], atol=2e-6)


def test_reference_loss_and_adam_equal_the_ports_twins():
    from gsplat_tpu_torch.train import losses, optim

    gen = torch.Generator().manual_seed(5)
    img, gt = torch.rand((2, 40, 56, 3), generator=gen)
    want, _ = losses.photometric_loss(img, gt, 0.2)
    assert abs(float(ref_train.photometric_loss(img, gt, 0.2)) - float(want)) < 1e-6
    params = {"xyz": torch.randn((9, 3), generator=gen), "opacity": torch.randn((9, 1), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    m = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in params.items()}
    v = {k: torch.rand(v.shape, generator=gen) * 0.1 for k, v in params.items()}
    lrs = {"xyz": 1e-3, "opacity": 0.025}
    p2, m2, v2, _ = optim.adam_update_torch(params, grads, m, v, torch.full((9,), 3), lrs)
    q2, n2, w2 = ref_train.adam(params, grads, m, v, 4, lrs)
    for k in params:
        assert torch.allclose(p2[k], q2[k], rtol=1e-6, atol=1e-9)
        assert torch.allclose(m2[k], n2[k]) and torch.allclose(v2[k], w2[k])


def test_reference_gradient_equals_the_ports_train_step():
    from gsplat_tpu_torch.config import OptimizationConfig
    from gsplat_tpu_torch.train.step import init_train_state, make_train_step

    _, settings, _ = port()
    params, cam = tiny(9, 64, 48)
    gt = torch.rand((48, 64, 3), generator=torch.Generator().manual_seed(1))
    step = make_train_step(OptimizationConfig(), settings(sh_degree=3, packet_dtype="float32"))
    state = init_train_state(dict(params), torch.ones(CONFIG["gaussians"], dtype=torch.bool), 1)
    zeros = torch.zeros((48, 64))
    state, metrics = step(state, port_camera(cam), gt, torch.ones((48, 64, 1)), zeros, zeros,
                          torch.zeros(3), 1e-4, 0.0, 0.0, 0)
    loss, grads = ref_train.loss_and_grads(params, cam, gt, torch.zeros(3), 0.2)
    assert abs(float(metrics["loss"]) - float(loss)) < 1e-6
    for k, g in grads.items():
        want = state.adam_m[k] / (1.0 - ref_train.ADAM_B1)
        assert torch.allclose(g, want, rtol=1e-3, atol=1e-6 * float(g.abs().max())), k
