"""The port's COLMAP reader and writers against the JAX package's.

The fixture is the gaussian-GT COLMAP scene of `scripts/make_fixtures.py`
at a small size (9 views of 96x64, 128 SfM points), plus a text-format copy
of its model, a `depth_params.json` and a `test.txt`. Each package reads
its own copy: a `points3D.ply` left by one reader would stand in for the
bins in the next (`ADVICE.md`), so the copies hold none.

- `read_scene_info` on both copies, binary and text, with and without
  `--depths`, with the llffhold split, the `test.txt` split and no split:
  R, T, fov, names, split, points, colours, `depth_params` with
  `med_scale`, the nerf++ normalization, all equal bit for bit. Binary
  models are read on the native path and on the Python path (the native
  path reads the doubles as float32, in both packages).
- `Scene` on both copies: the loaded views' cameras and pixels equal.
- `write_model` of one package read back by the other's readers, binary
  and text, both ways.
- The train CLI on the scene on the CPU, and the render CLI on its model.
"""

import json
import os
import shutil

import numpy as np
import pytest

from gsplat_tpu.data import colmap as jcolmap
from gsplat_tpu.data import native as jnative
from gsplat_tpu.data import readers as jreaders
from gsplat_tpu_torch.data import colmap as tcolmap
from gsplat_tpu_torch.data import native as tnative
from gsplat_tpu_torch.data import readers as treaders

N_VIEWS, N_POINTS = 9, 128


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The generated scene with no `points3D.ply`, a text-format model
    beside it (`sparse_txt/0`), depth parameters and a test list."""
    from scripts.make_fixtures import make_colmap_gaussian_scene

    d = str(tmp_path_factory.mktemp("colmap_torch") / "scene")
    make_colmap_gaussian_scene(d, n_gauss=256, n_points=N_POINTS, n_images=N_VIEWS,
                               width=96, height=64, focal=90.0, seed=7)
    sparse = os.path.join(d, "sparse", "0")
    os.remove(os.path.join(sparse, "points3D.ply"))  # written by the generator's own read
    rng = np.random.default_rng(5)
    # scales: a zero, a negative one and two outliers around the median
    scales = [0.0, -1.0, 0.1, 1.0, 1.2, 0.9, 9.0, 1.1]
    params = {f"r_{i:03d}": {"scale": s, "offset": float(rng.normal())}
              for i, s in enumerate(scales)}  # r_008 has no entry
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(params, f)
    with open(os.path.join(sparse, "test.txt"), "w") as f:
        f.write("r_002.png\nr_005.png\n")

    cams = jcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = jcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    pts = jcolmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    jcolmap.write_model(cams, imgs, pts, os.path.join(d, "sparse_txt", "0"), ext=".txt")
    return d


def scene_copy(root, dst, fmt):
    """A copy of the fixture with the binary or the text model as `sparse`."""
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns("sparse", "sparse_txt"))
    shutil.copytree(os.path.join(root, "sparse"), os.path.join(dst, "sparse"))
    if fmt == "txt":
        sparse = os.path.join(dst, "sparse", "0")
        for name in ("cameras", "images", "points3D"):
            os.remove(os.path.join(sparse, name + ".bin"))
            shutil.copy(os.path.join(root, "sparse_txt", "0", name + ".txt"), sparse)
    return str(dst)


@pytest.fixture
def native_path(monkeypatch, request):
    """Both packages' binary readers on one path. Native: the JAX loader
    gets the port's library object, built from the same source, because
    the JAX loader builds with an unlocked `make` that parallel test
    workers race on (`gsplat_tpu/data/native.py:33-43`). Python: both
    loaders off."""
    if request.param == "native":
        monkeypatch.setattr(jnative, "_LIB", tnative._load())
        assert tnative.available()
    else:
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return request.param


def rel(path, root):
    return os.path.relpath(path, root) if path else path


def assert_same_cameras(jcams, tcams, jroot, troot):
    assert [c.image_name for c in jcams] == [c.image_name for c in tcams]
    for j, t in zip(jcams, tcams):
        assert (t.uid, t.width, t.height, t.is_test) == (j.uid, j.width, j.height, j.is_test)
        np.testing.assert_array_equal(t.R, j.R)
        np.testing.assert_array_equal(t.T, j.T)
        assert (t.fovx, t.fovy) == (j.fovx, j.fovy)
        assert rel(t.image_path, troot) == rel(j.image_path, jroot)
        assert rel(t.depth_path, troot) == rel(j.depth_path, jroot)
        assert t.depth_params == j.depth_params


SPLITS = {"llffhold": dict(eval=True), "test_txt": dict(eval=True, llffhold=0),
          "none": dict(eval=False)}


@pytest.mark.parametrize("native_path, fmt", [("native", "bin"), ("python", "bin"),
                                              ("python", "txt")], indirect=["native_path"])
@pytest.mark.parametrize("depths", ["", "depths"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_reader_matches_jax(fixture_root, tmp_path, native_path, fmt, depths, split):
    jroot = scene_copy(fixture_root, tmp_path / "jax", fmt)
    troot = scene_copy(fixture_root, tmp_path / "torch", fmt)
    kw = dict(depths=depths, **SPLITS[split])
    j = jreaders.read_scene_info(jroot, **kw)
    t = treaders.read_scene_info(troot, **kw)

    assert not t.is_nerf_synthetic and not j.is_nerf_synthetic
    assert len(t.train_cameras) + len(t.test_cameras) == N_VIEWS
    want_test = {"llffhold": 2, "test_txt": 2, "none": 0}[split]
    assert len(t.test_cameras) == want_test
    assert_same_cameras(j.train_cameras, t.train_cameras, jroot, troot)
    assert_same_cameras(j.test_cameras, t.test_cameras, jroot, troot)
    if depths:
        dp = t.train_cameras[1].depth_params
        assert dp["med_scale"] == float(np.median([0.1, 1.0, 1.2, 0.9, 9.0, 1.1]))
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    assert t.points.shape == (N_POINTS, 3)
    np.testing.assert_array_equal(t.nerf_normalization["translate"],
                                  j.nerf_normalization["translate"])
    assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    # the first read writes points3D.ply beside the model; the next reads it
    assert rel(t.ply_path, troot) == rel(j.ply_path, jroot) == "sparse/0/points3D.ply"
    again = treaders.read_scene_info(troot, **kw)
    np.testing.assert_array_equal(again.points, t.points)
    np.testing.assert_array_equal(again.colors, t.colors)


def test_reader_refuses_distorted_cameras(fixture_root, tmp_path):
    root = scene_copy(fixture_root, tmp_path / "s", "txt")
    path = os.path.join(root, "sparse", "0", "cameras.txt")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace(" PINHOLE ", " OPENCV "))
    with pytest.raises(ValueError, match="OPENCV"):
        treaders.read_scene_info(root)
    os.remove(os.path.join(root, "sparse", "0", "depth_params.json"))
    with pytest.raises(FileNotFoundError, match="depth_params"):
        treaders.read_scene_info(root, depths="depths")


def test_scene_loads_the_same_views(fixture_root, tmp_path):
    from gsplat_tpu.data.scene import Scene as JScene
    from gsplat_tpu_torch.data.scene import Scene as TScene

    kw = dict(model_path=None, images="images", depths="", resolution=-1,
              white_background=False, eval=True, train_test_exp=False)
    j = JScene(scene_copy(fixture_root, tmp_path / "jax", "bin"), **kw)
    t = TScene(scene_copy(fixture_root, tmp_path / "torch", "bin"), device="cpu", **kw)
    assert t.cameras_extent == j.cameras_extent
    for jc, tc in zip(j.get_train_cameras() + j.get_test_cameras(),
                      t.get_train_cameras() + t.get_test_cameras()):
        assert (tc.image_name, tc.uid, tc.colmap_id) == (jc.image_name, jc.uid, jc.colmap_id)
        np.testing.assert_array_equal(tc.image, jc.image)
        for f in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(tc.camera, f).numpy(),
                                          np.asarray(getattr(jc.camera, f), np.float32))


def colmap_model(seed):
    """The same two cameras and three images with 2D points in each
    package's types, and 40 points."""
    def model(mod, r):
        cams = {1: mod.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.5, 510.25, 320.0, 240.0])),
                3: mod.ColmapCamera(3, "SIMPLE_PINHOLE", 320, 200, np.array([290.125, 160.0, 100.0]))}
        imgs = {}
        for iid, cid in ((1, 1), (2, 3), (7, 1)):
            q = r.normal(size=4)
            imgs[iid] = mod.ColmapImage(iid, q / np.linalg.norm(q), r.normal(size=3), cid,
                                        f"view_{iid}.png", r.normal(size=(iid, 2)) * 100,
                                        r.integers(-1, 40, iid).astype(np.int64))
        return cams, imgs

    r = np.random.default_rng(seed)
    pts = (r.normal(size=(40, 3)), r.integers(0, 256, (40, 3)).astype(np.uint8),
           r.random(40))
    return (model(jcolmap, np.random.default_rng(seed + 1)),
            model(tcolmap, np.random.default_rng(seed + 1)), pts)


@pytest.mark.parametrize("native_path", ["native", "python"], indirect=True)
@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_writer_round_trip_across_packages(tmp_path, native_path, ext, writer):
    (jcams, jimgs), (tcams, timgs), pts = colmap_model(11)
    out = str(tmp_path / "model")
    if writer == "jax":
        jcolmap.write_model(jcams, jimgs, pts, out, ext=ext)
        reader, cams, imgs = tcolmap, tcams, timgs
    else:
        tcolmap.write_model(tcams, timgs, pts, out, ext=ext)
        reader, cams, imgs = jcolmap, jcams, jimgs
    kind = "binary" if ext == ".bin" else "text"
    rc = getattr(reader, f"read_cameras_{kind}")(os.path.join(out, "cameras" + ext))
    ri = getattr(reader, f"read_images_{kind}")(os.path.join(out, "images" + ext))
    rp = getattr(reader, f"read_points3d_{kind}")(os.path.join(out, "points3D" + ext))
    # the native binary path reads doubles as float32 and skips the 2D points
    lossy = ext == ".bin" and native_path == "native"
    cast = (lambda a: np.asarray(a).astype(np.float32)) if lossy else np.asarray

    assert set(rc) == set(cams)
    for cid, c in cams.items():
        assert (rc[cid].model, rc[cid].width, rc[cid].height) == (c.model, c.width, c.height)
        np.testing.assert_array_equal(rc[cid].params, cast(c.params))
    assert set(ri) == set(imgs)
    for iid, im in imgs.items():
        got = ri[iid]
        assert (got.name, got.camera_id) == (im.name, im.camera_id)
        np.testing.assert_array_equal(got.qvec, cast(im.qvec))
        np.testing.assert_array_equal(got.tvec, cast(im.tvec))
        if not lossy:
            np.testing.assert_array_equal(got.xys, im.xys)
            np.testing.assert_array_equal(got.point3d_ids, im.point3d_ids)
    np.testing.assert_array_equal(rp[0], cast(pts[0]))
    np.testing.assert_array_equal(rp[1], pts[1])
    np.testing.assert_array_equal(rp[2], cast(pts[2]))


def test_train_and_render_cli_on_colmap_scene(fixture_root, tmp_path):
    """Five iterations of the port's train CLI on the COLMAP scene on the
    CPU (a densify round forced into them), then its render CLI on the
    model: the held-out views render and the snapshot loads in the JAX
    package with the port's values."""
    from gsplat_tpu.io.snapshot import load_snapshot as j_load_snapshot
    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.io.snapshot import load_snapshot as t_load_snapshot

    src = scene_copy(fixture_root, tmp_path / "scene", "bin")
    model = str(tmp_path / "model")
    assert train_cli.main([
        "-s", src, "-m", model, "--eval", "--sh_degree", "1", "--iterations", "5",
        "--densify_from_iter", "1", "--densification_interval", "4",
        "--densify_grad_threshold", "1e-9", "--device", "cpu", "--quiet",
        "--disable_viewer"]) == 0
    tp, ta, it, _ = t_load_snapshot(model, device="cpu")
    jp, ja, _, _ = j_load_snapshot(model)
    n = int(ta.sum())
    assert it == 5 and n == int(np.asarray(ja).sum()) > N_POINTS
    np.testing.assert_array_equal(tp.xyz.detach().numpy()[:n], np.asarray(jp.xyz)[:n])
    assert render_cli.main(["-m", model, "-s", src, "--device", "cpu", "--quiet",
                            "--skip_train"]) == 0
    renders = os.path.join(model, "test", "ours_5", "renders")
    assert len(os.listdir(renders)) == 2
