"""The port's fixture generator and COLMAP quality chain on the CPU.

- `gsplat_tpu_torch/scripts/make_fixtures.py` against `scripts/make_fixtures.py`:
  the gaussian-GT COLMAP scene at 9 views of 96x64, focal 90, 256
  gaussians, 128 points, seed 7 (the size of `tests/test_torch_colmap.py`),
  directly and through `fixture_diff.compare`:
  `cameras.bin`, `images.bin`, `points3D.bin` and the reader's
  `points3D.ply` byte for byte, every ground-truth PNG within 1 uint8 level
  (the two renders round apart; float32 render tolerance); the one- and
  two-gaussian snapshots (arrays bit for bit, PLY bytes), the disc-splat
  scene and `main` (every file byte for byte);
- the fixture against itself through the port, as
  `tests/test_colmap_e2e.py:137` holds the JAX one: the known cloud
  re-rendered from a loaded view within 1.5/255 of the saved PNG, the
  loaded pixels within 1/255;
- `gsplat_tpu_torch/scripts/colmap_proxy.py` end to end at that size for
  30 iterations, in this process and through the supervisor:
  `summary.json` with the JAX collector's keys, the step time from the
  log, the copied `model_*` files, a stale `points3D.ply` removed before
  the scene is written; the collector's log reading on a log with a
  relaunch;
- `bench.measure_render_only_trained` on that run's snapshot: the JAX
  bench's keys, `n_gauss` the snapshot's alive count, None when a
  directory is missing; the warp cull's counts on the trained state.
"""

import contextlib
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gsplat_tpu_torch import bench
from gsplat_tpu_torch.scripts import colmap_proxy as cp
from gsplat_tpu_torch.scripts import fixture_diff
from gsplat_tpu_torch.scripts import make_fixtures as tfix
from gsplat_tpu_torch.train import loop

SMALL = cp.SMALL_RECIPE
ITERS = 30
BINS = ("cameras.bin", "images.bin", "points3D.bin", "points3D.ply")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_png(path):
    with Image.open(path) as im:
        return np.asarray(im, np.int16)


def test_gaussian_scene_matches_jax(tmp_path):
    from scripts.make_fixtures import make_colmap_gaussian_scene as jax_scene

    jax_scene(str(tmp_path / "jax"), **SMALL)
    tfix.make_colmap_gaussian_scene(str(tmp_path / "port"), **SMALL, device="cpu")
    diff = fixture_diff.compare(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert diff["bins_equal"] == dict.fromkeys(sorted(BINS), True)
    assert diff["png_max_levels"] <= 1 and diff["views_over_one_level"] == 0
    assert diff["pixels"] == SMALL["n_images"] * SMALL["width"] * SMALL["height"]
    for name in BINS:
        assert filecmp.cmp(tmp_path / "jax" / "sparse" / "0" / name,
                           tmp_path / "port" / "sparse" / "0" / name, shallow=False), name
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images"))
    assert len(names) == SMALL["n_images"]
    for nm in names:
        a = read_png(tmp_path / "jax" / "images" / nm)
        b = read_png(tmp_path / "port" / "images" / nm)
        assert a.shape == b.shape == (SMALL["height"], SMALL["width"], 3)
        assert np.abs(a - b).max() <= 1, nm
        assert a.std() > 10  # the views show the cloud


@pytest.mark.parametrize("name", ["single_gaussian", "two_gaussians"])
def test_snapshot_fixture_matches_jax(tmp_path, name):
    import scripts.make_fixtures as jfix
    from gsplat_tpu.data import ply as jply
    from gsplat_tpu_torch.data import ply as tply

    want, got = getattr(jfix, name)(), getattr(tfix, name)()
    for w, g in zip(want, got, strict=True):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    jply.save_gaussian_ply(str(tmp_path / "jax.ply"), *want)
    tply.save_gaussian_ply(str(tmp_path / "port.ply"), *got)
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()


def assert_trees_equal(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    return files


def test_disc_splat_scene_matches_jax(tmp_path):
    from scripts.make_fixtures import make_colmap_scene as jax_scene

    kw = dict(n_points=120, n_images=5, width=64, height=48, focal=70.0, seed=2)
    jax_scene(str(tmp_path / "jax"), **kw)
    tfix.make_colmap_scene(str(tmp_path / "port"), **kw)
    files = assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    assert len(files) == 3 + kw["n_images"]
    assert read_png(tmp_path / "port" / "images" / "r_000.png").std() > 1


def test_main_matches_jax(tmp_path):
    from scripts.make_fixtures import main as jax_main

    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["--out", str(tmp_path / "jax"), "--colmap"]) == 0
        assert tfix.main(["--out", str(tmp_path / "port"), "--colmap"]) == 0
    files = assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    assert {"single_gaussian.ply", "two_gaussians.ply",
            os.path.join("colmap_scene", "sparse", "0", "points3D.bin")} <= set(files)


def test_gaussian_scene_is_self_consistent(tmp_path):
    """The saved ground truth is the known cloud rendered from the views the
    port's reader loads back (`tests/test_colmap_e2e.py:137-193`)."""
    from gsplat_tpu_torch.convert import params_from_numpy
    from gsplat_tpu_torch.core.sh import rgb_to_sh
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.render import render

    d = str(tmp_path / "scene")
    small = {**SMALL, "n_images": 4}
    tfix.make_colmap_gaussian_scene(d, **small, device="cpu")
    scene = load_scene(d, "cpu")
    cams = scene.get_train_cameras()
    assert len(cams) == 4

    # the same cloud, drawn again from the seed in the generator's order
    n, g = small["n_gauss"], np.random.default_rng(small["seed"])
    xyz = g.normal(0, 0.45, (n, 3))
    log_scaling = np.log(g.uniform(0.015, 0.09, (n, 3)))
    rotation = g.normal(size=(n, 4))
    rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
    logit_opacity = g.uniform(0.5, 3.0, (n, 1))
    color = np.clip(xyz * 0.5 + 0.5 + g.normal(0, 0.08, (n, 3)), 0, 1)
    params = params_from_numpy({"xyz": xyz, "features_dc": rgb_to_sh(color)[:, None, :],
                                "features_rest": np.zeros((n, 15, 3)), "scaling": log_scaling,
                                "rotation": rotation, "opacity": logit_opacity}, "cpu")
    settings = make_render_settings(sh_degree=3)
    for i in (0, 3):
        with torch.no_grad():
            img = render(cams[i].camera, params, torch.ones(n, dtype=torch.bool), settings,
                         [0.0, 0.0, 0.0], device="cpu")["render"].numpy()
        saved = read_png(os.path.join(d, "images", f"r_{i:03d}.png")) / 255.0
        assert np.abs(np.clip(img, 0, 1) - saved).max() <= 1.5 / 255.0
        assert np.abs(cams[i].image - saved).max() <= 1.0 / 255.0


@pytest.fixture(scope="module")
def chain_run(tmp_path_factory):
    """`colmap_proxy.main` in this process at the small size for ITERS
    iterations on the CPU, without tensorboard events (where tensorflow is
    installed, its writer takes many seconds to import), over a run
    directory whose scene holds a stale 5-point `points3D.ply`."""
    out = tmp_path_factory.mktemp("colmap_proxy") / "run"
    sparse = out / "scene" / "sparse" / "0"
    sparse.mkdir(parents=True)
    from gsplat_tpu_torch.data.ply import write_point_cloud

    write_point_cloud(str(sparse / "points3D.ply"), np.zeros((5, 3)), np.zeros((5, 3), np.uint8))
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "_summary_writer", lambda model_path: None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cp.main(["--out", str(out), "--seed", "0", "--iterations", str(ITERS),
                      "--device", "cpu", "--in_process", "--small"])
    mp.undo()
    assert rc == 0, buf.getvalue()[-2000:]
    return out


JAX_KEYS = {"results", "train_minutes", "train_minutes_tb", "steady_iter_ms_median"}


def test_chain_writes_summary_with_the_jax_keys(chain_run):
    with open(chain_run / "summary.json") as f:
        summary = json.load(f)
    row = summary["model"]
    assert set(summary) == {"model"} and JAX_KEYS <= set(row)
    res = row["results"][f"ours_{ITERS}"]
    assert res["LPIPS"] is None and res["LPIPS_status"] == "weights_unavailable"
    assert 10.0 < res["PSNR"] < 60.0 and 0.0 < res["SSIM"] <= 1.0
    # the step time comes from the log's timed lines; 30 iterations hold no
    # steady window for the median
    assert row["train_minutes_tb"] is None and row["steady_iter_ms_median"] is None
    assert row["steady_iter_ms_mean"] > 0 and row["steady_from"] == ITERS // 2
    assert row["train_minutes"] is not None and row["final_alive"] > 0
    assert row["alive"] == {str(ITERS): row["final_alive"]}
    assert set(row["test_psnr_log"]) == {str(ITERS)}
    assert abs(row["test_psnr_log"][str(ITERS)] - res["PSNR"]) < 3.0
    assert row["recipe"] == SMALL and row["device"]["platform"] == "cpu"
    for name in cp.COPIED:
        assert filecmp.cmp(chain_run / f"model_{name}", chain_run / "model" / name,
                           shallow=False)
    assert len(os.listdir(chain_run / "model" / "test" / f"ours_{ITERS}" / "renders")) == 2


def test_chain_regenerates_a_stale_scene(chain_run):
    from gsplat_tpu_torch.data import colmap
    from gsplat_tpu_torch.data.ply import read_point_cloud

    pts = colmap.read_points3d_binary(str(chain_run / "scene" / "sparse" / "0" / "points3D.bin"))
    for ply in (chain_run / "scene" / "sparse" / "0" / "points3D.ply",
                chain_run / "model" / "input.ply"):
        xyz = read_point_cloud(str(ply))[0]
        assert xyz.shape == (SMALL["n_points"], 3)
        np.testing.assert_allclose(xyz, pts[0], atol=1e-6)


def test_trained_cloud_row_and_cull(chain_run):
    from gsplat_tpu_torch.io.snapshot import load_snapshot

    model, scene = str(chain_run / "model"), str(chain_run / "scene")
    _, alive, _, _ = load_snapshot(model, ITERS, device="cpu")
    row = bench.measure_render_only_trained(model, scene, iters=2, iteration=ITERS, device="cpu")
    assert set(row) == {"pixels_per_s", "ms", "n_gauss", "vs_baseline"}
    assert row["n_gauss"] == int(alive.sum()) > 0 and row["pixels_per_s"] > 0
    assert bench.measure_render_only_trained(str(chain_run / "absent"), scene) is None
    assert bench.measure_render_only_trained(model, str(chain_run / "absent")) is None

    with open(chain_run / "summary.json") as f:
        report = json.load(f)["model"]["trained_cloud"][str(ITERS)]
    assert report["render_only"]["n_gauss"] == row["n_gauss"]
    for dtype in ("float32", "hybrid"):
        cull = report["cull"][dtype]
        assert cull["instances"] > 0 and cull["kept_pairs"] > 0
        assert cull["kept_outside_box"] == 0 and cull["kept_unreached"] == 0
        assert cull["whole_plane"] == cull["whole_plane_nonfinite"] + cull["whole_plane_degenerate"]
        assert 0.0 <= cull["whole_plane_share"] <= 1.0
        assert 0.0 < cull["culled_share"]["blocks_8x4"] < 1.0


def test_projection_snapshot_check(chain_run):
    """`plain_projection.snapshot_check` on the chain's snapshot: every
    train view differentiated, the backward (the twin on the CPU) and
    float32 autograd each measured against float64 autograd."""
    from gsplat_tpu_torch.scripts.plain_projection import snapshot_check

    res = snapshot_check(str(chain_run / "model"), str(chain_run / "scene"), ITERS, "cpu")
    n = SMALL["n_images"]
    assert len(res["views"]) == n - len(range(0, n, 8)) and res["live"] > 0
    for v in res["views"]:
        assert v["equal_to_twin"] and v["nonfinite"] == [0, 0] and v["visible"] > 0
        assert 0.0 < v["autograd_vs_float64"] < 1e-3 and v["kernel_vs_float64"] < 1e-3


def test_bench_scans_trained_runs(chain_run, tmp_path, monkeypatch):
    """`trained_rows` renders the first candidate of each scene that exists
    and skips the rest; `run` renders none."""
    monkeypatch.chdir(tmp_path)
    assert bench.trained_rows(device="cpu") == {}
    os.makedirs("output/colmap_proxy_torch")
    os.symlink(chain_run, "output/colmap_proxy_torch/seed1")
    monkeypatch.setattr(bench, "RENDER_ITERS", 1)
    with pytest.raises(FileNotFoundError):  # the run has no 30k snapshot
        bench.measure_render_only_trained("output/colmap_proxy_torch/seed1/model",
                                          "output/colmap_proxy_torch/seed1/scene", device="cpu")
    assert bench.trained_rows(device="cpu") == {}
    (chain_run / "model" / "point_cloud" / f"iteration_{ITERS}").rename(
        chain_run / "model" / "point_cloud" / "iteration_30000")
    try:
        rows = bench.trained_rows(device="cpu")
        # `run` leaves the trained rows to `main`
        points = bench.run(512, 64, 48, device="cpu")["points"]
    finally:
        (chain_run / "model" / "point_cloud" / "iteration_30000").rename(
            chain_run / "model" / "point_cloud" / f"iteration_{ITERS}")
    assert set(points["render_only"]) == {"1M_gauss_1080p"}
    assert set(rows) == {"colmap_proxy_30k_400x304"}
    assert set(rows["colmap_proxy_30k_400x304"]) == {"pixels_per_s", "ms", "n_gauss",
                                                     "vs_baseline"}


def test_chain_through_the_supervisor(tmp_path):
    """The default path: the supervisor in a child process; the step time
    comes from the log whether or not tensorboard wrote events. Arguments
    after `--` reach the train CLI."""
    out = tmp_path / "run"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cp.main(["--out", str(out), "--seed", "1", "--iterations", "20", "--device",
                        "cpu", "--skip_report", "--small", "--", "--log_every", "5"]) == 0
    with open(out / "summary.json") as f:
        row = json.load(f)["model"]
    assert JAX_KEYS <= set(row) and "trained_cloud" not in row
    assert row["train_args_extra"] == ["--log_every", "5"] and "it     15" in (
        out / "model" / cp.LOG).read_text()
    log = (out / "model" / cp.LOG).read_text()
    assert "supervisor: attempt 1" in log and "it     20" in log
    assert row["train_minutes_tb"] is None and row["steady_iter_ms_mean"] > 0
    assert row["results"]["ours_20"]["PSNR"] > 10.0


def test_log_reading_across_a_relaunch(tmp_path, monkeypatch):
    monkeypatch.setattr(cp, "STEADY_WINDOW", 20)
    log = tmp_path / "train.log"
    log.write_text(
        "\n===== supervisor: attempt 1 =====\n"
        "it     10  loss 0.1  depth 0.0  alive 100  vis 90  (1.0s)\n"
        "it     20  loss 0.1  depth 0.0  alive 110  vis 90  (2.0s)\n"
        "\n[ITER 20] test: L1 0.05000 PSNR 21.50\n\n"
        "it     30  loss 0.1  depth 0.0  alive 120  vis 90  (3.5s)\n"
        "it     40  loss 0.1  depth 0.0  alive 125  vis 90  (4.0s)\n"
        "\n===== supervisor: attempt 2 =====\n"
        "Resumed from rolling_chkpnt.pkl at iteration 30\n"
        "it     40  loss 0.1  depth 0.0  alive 130  vis 90  (0.5s)\n"
        "it     50  loss 0.1  depth 0.0  alive 140  vis 90  (1.3s)\n"
        "it     60  loss 0.1  depth 0.0  alive 150  vis 90  (61.3s)\n"
        "it     70  loss 0.1  depth 0.0  alive 160  vis 90  (61.9s)\n"
        "it     80  loss 0.1  depth 0.0  alive 170  vis 90  (62.5s)\n")
    assert cp.wall_minutes(str(log)) == round((4.0 + 62.5) / 60.0, 1)
    got = cp.read_log(str(log), steady_from=20)
    # 20-iteration windows 20-40 (100 ms), 40-60 (3,040 ms) and 60-80
    # (60 ms); 40-40 crosses the relaunch
    assert got["steady_iter_ms_median"] == pytest.approx(100.0)
    # every 10-iteration interval past 20 but the one across the relaunch
    assert got["steady_iter_ms_mean"] == pytest.approx(1e3 * (1.5 + 0.5 + 0.8 + 60.0 + 1.2) / 60)
    assert got["alive"] == {10: 100, 20: 110, 30: 120, 40: 130, 50: 140, 60: 150, 70: 160,
                            80: 170}
    assert got["test_psnr"] == {20: 21.5}
    absent = cp.read_log(str(tmp_path / "absent.log"))
    assert absent["steady_iter_ms_median"] is None and absent["steady_iter_ms_mean"] is None
    assert cp.schedule(30_000) == ([1_500, 7_000, 30_000], [7_000, 30_000])
    assert cp.schedule(1_500) == ([1_500], [1_500])
