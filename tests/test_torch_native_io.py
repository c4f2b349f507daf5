"""The port's native IO library (`gsplat_tpu_torch/data/native.py`).

- Its native parsers against its Python parsers on the same files: a
  reference-layout gaussian PLY and a COLMAP binary model with tracks and
  2D points (the native path reads the model's doubles as float32).
- The native all-float PLY writer, read back by the Python parser.
- A snapshot round trip through the native PLY reader.
- Six processes that load the library at once into an empty build
  directory all get it: the build is atomic and locked.

None of these skip: the library builds with `g++`, which this machine and
the card's have.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

from gsplat_tpu_torch.data import colmap as colmap_io
from gsplat_tpu_torch.data import native
from gsplat_tpu_torch.data import ply as ply_io

ROOT = Path(__file__).resolve().parents[1]


def snapshot_arrays(rng, n):
    return dict(
        xyz=rng.standard_normal((n, 3)).astype(np.float32),
        features_dc=rng.standard_normal((n, 1, 3)).astype(np.float32),
        features_rest=rng.standard_normal((n, 15, 3)).astype(np.float32),
        opacity=rng.standard_normal((n, 1)).astype(np.float32),
        scaling=rng.standard_normal((n, 3)).astype(np.float32),
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
    )


def save_snapshot(path, a):
    ply_io.save_gaussian_ply(path, a["xyz"], a["features_dc"], a["features_rest"],
                             a["opacity"], a["scaling"], a["rotation"])


def test_library_builds_and_loads():
    assert native.available()
    assert native.library_path().exists()


def test_gaussian_ply_native_matches_python(rng, tmp_path):
    path = str(tmp_path / "g.ply")
    save_snapshot(path, snapshot_arrays(rng, 500))
    names, cols = native.ply_read_columns(path)
    v = ply_io.read_ply(path)["vertex"]
    assert names == list(v.dtype.names)
    for nm in names:
        np.testing.assert_array_equal(cols[nm], v[nm])


def test_native_ply_writer_read_by_python(rng, tmp_path):
    names = ["x", "y", "z", "opacity"]
    cols = rng.standard_normal((4, 300)).astype(np.float32)
    path = str(tmp_path / "w.ply")
    assert native.ply_write_columns(path, names, cols)
    v = ply_io.read_ply(path)["vertex"]
    assert list(v.dtype.names) == names
    for i, nm in enumerate(names):
        np.testing.assert_array_equal(v[nm], cols[i])


def test_snapshot_roundtrip_native_and_python_agree(rng, tmp_path, monkeypatch):
    arrs = snapshot_arrays(rng, 64)
    path = str(tmp_path / "snap.ply")
    save_snapshot(path, arrs)
    fast = ply_io.load_gaussian_ply(path)
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = ply_io.load_gaussian_ply(path)
    for k in arrs:
        np.testing.assert_array_equal(fast[k], arrs[k], err_msg=k)
        np.testing.assert_array_equal(slow[k], arrs[k], err_msg=k)


def write_colmap_bins(d):
    """One PINHOLE and one SIMPLE_PINHOLE camera, three images with 2D
    points, four 3D points with tracks."""
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        f.write(struct.pack("<dddd", 500.25, 510.5, 320.0, 240.0))
        f.write(struct.pack("<iiQQ", 2, 0, 320, 200))
        f.write(struct.pack("<ddd", 290.125, 160.0, 100.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid, cam, name in ((1, 1, b"a.png"), (2, 2, b"bb.jpg"), (5, 1, b"c.png")):
            f.write(struct.pack("<i", iid))
            q = np.array([1.0, 0.1 * iid, -0.2, 0.3])
            f.write(struct.pack("<7d", *(q / np.linalg.norm(q)), 0.1 * iid, 0.2, -1.3))
            f.write(struct.pack("<i", cam))
            f.write(name + b"\x00")
            f.write(struct.pack("<Q", iid))
            for j in range(iid):
                f.write(struct.pack("<ddq", 1.5 * j, 2.0, j - 1))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 4))
        for pid in range(4):
            f.write(struct.pack("<Q", pid + 10))
            f.write(struct.pack("<3d", pid * 0.1, pid + 0.5, -pid / 3.0))
            f.write(bytes([10 * pid, 20, 255 - pid]))
            f.write(struct.pack("<d", 0.25 * pid))
            f.write(struct.pack("<Q", pid))
            for t in range(pid):
                f.write(struct.pack("<ii", t + 1, t))


def read_bins(d):
    return (colmap_io.read_cameras_binary(os.path.join(d, "cameras.bin")),
            colmap_io.read_images_binary(os.path.join(d, "images.bin")),
            colmap_io.read_points3d_binary(os.path.join(d, "points3D.bin")))


def test_colmap_bins_native_matches_python(tmp_path, monkeypatch):
    write_colmap_bins(str(tmp_path))
    cams, imgs, pts = read_bins(str(tmp_path))
    monkeypatch.setattr(native, "_load", lambda: None)
    pcams, pimgs, ppts = read_bins(str(tmp_path))

    assert set(cams) == set(pcams) == {1, 2}
    for cid in cams:
        a, b = cams[cid], pcams[cid]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        # the native path reads the doubles as float32
        np.testing.assert_array_equal(a.params, b.params.astype(np.float32))
    assert cams[2].model == "SIMPLE_PINHOLE" and cams[2].params.shape == (3,)
    assert set(imgs) == set(pimgs) == {1, 2, 5}
    for iid in imgs:
        a, b = imgs[iid], pimgs[iid]
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        np.testing.assert_array_equal(a.qvec, b.qvec.astype(np.float32))
        np.testing.assert_array_equal(a.tvec, b.tvec.astype(np.float32))
        assert len(b.point3d_ids) == iid  # the Python path keeps the 2D points
    for got, want in zip(pts, ppts):
        np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype))
    np.testing.assert_array_equal(pts[1][3], [30, 20, 252])


def test_six_concurrent_first_loads_all_succeed(tmp_path):
    """Six processes load the library at once into one empty build
    directory; each must get a working library, and no temporary file may
    be left behind."""
    build = tmp_path / "build"
    probe = tmp_path / "probe.ply"
    ply_io.write_point_cloud(str(probe), np.arange(12.0).reshape(4, 3),
                             np.full((4, 3), 7))
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from gsplat_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "names, cols = native.ply_read_columns(sys.argv[2])\n"
        "assert names[:3] == ['x', 'y', 'z'] and cols['z'].tolist() == [2, 5, 8, 11], names\n"
        "print('loaded', native.library_path().name)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), str(probe)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.startswith("loaded"), err
    assert len({out for out, _ in outs}) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(
        [outs[0][0].split()[1], "libgsplat_native.lock"])
