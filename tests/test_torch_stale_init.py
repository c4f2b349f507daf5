"""`gsplat_tpu_torch/scripts/stale_init.py` on the CPU: the quality chain
from the disc-splat scene's `points3D.ply`, at `colmap_proxy.SMALL_RECIPE`.

- The stale cloud is what the JAX generators leave: its points are the JAX
  `scripts/make_fixtures.make_colmap_scene`'s bins read back (the port's
  disc-splat bins equal the JAX ones byte for byte,
  `tests/test_torch_fixtures.py`), and they hold every ground-truth centre
  of the gaussian scene (`gaussian_gt_cloud`, same seed) exactly, to the
  ply's float32.
- The chain runs 30 iterations in-process and its summary names the init.
"""

import json
import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.scripts import colmap_proxy as cp
from gsplat_tpu_torch.scripts import make_fixtures as tfix
from gsplat_tpu_torch.scripts import stale_init


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_disc_recipe_is_the_jax_scripts():
    assert stale_init.disc_recipe_for(cp.RECIPE) == dict(
        n_points=5000, n_images=64, width=400, height=304, focal=380.0, seed=3)
    assert cp.RECIPE["seed"] == stale_init.DISC_RECIPE["seed"]
    assert cp.RECIPE["n_gauss"] < stale_init.DISC_RECIPE["n_points"]


def test_stale_ply_holds_every_ground_truth_centre(tmp_path):
    from scripts.make_fixtures import make_colmap_scene as jax_disc_scene

    small = cp.SMALL_RECIPE
    scene = str(tmp_path / "scene")
    tfix.make_colmap_gaussian_scene(scene, **small, device="cpu")
    disc = stale_init.disc_recipe_for(small)
    n = stale_init.stale_ply(scene, disc, "cpu")
    assert n == disc["n_points"]
    pts, _, _ = ply_io.read_point_cloud(os.path.join(scene, "sparse", "0", "points3D.ply"))

    # the JAX generator's disc-splat points, as the reader writes them
    jax_disc_scene(str(tmp_path / "jax"), **disc)
    from gsplat_tpu_torch.data.colmap import read_points3d_binary

    xyz, _, _ = read_points3d_binary(str(tmp_path / "jax" / "sparse" / "0" / "points3D.bin"))
    np.testing.assert_array_equal(np.sort(pts, axis=0),
                                  np.sort(np.asarray(xyz, np.float32), axis=0))

    gt = tfix.gaussian_gt_cloud(small["n_gauss"], np.random.default_rng(small["seed"]))[0]["xyz"]
    have = {tuple(p) for p in pts.astype(np.float32)}
    assert all(tuple(c) in have for c in gt.astype(np.float32))


def test_chain_from_the_stale_init(tmp_path):
    out = str(tmp_path / "run")
    assert stale_init.main(["--out", out, "--small", "--iterations", "30", "--device", "cpu",
                            "--in_process"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        row = json.load(f)["model"]
    small = cp.SMALL_RECIPE
    assert row["init"]["points"] == small["n_gauss"] + small["n_points"]
    assert np.isfinite(row["results"]["ours_30"]["PSNR"])
    assert row["test_psnr_log"]["30"] > 0
