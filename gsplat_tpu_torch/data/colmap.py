"""COLMAP sparse-model parsers and writers (binary + text).

Copy of `gsplat_tpu/data/colmap.py`; the binary readers go through the
port's native library (`data/native.py`) when it is available. A
standalone reimplementation of the subset of the COLMAP model format the
reference consumes (`scene/colmap_loader.py:125-294`): camera intrinsics,
image extrinsics, and the 3D point cloud, in both `.bin` and `.txt` forms.
Parsing is numpy-vectorized where the record layout allows (points3D tracks
are skipped by offset arithmetic instead of per-point reads).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass(frozen=True)
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass(frozen=True)
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3d_ids: np.ndarray  # (M,)


def qvec2rotmat(qvec):
    """Quaternion (wxyz) -> rotation matrix, same element layout as the
    reference (`colmap_loader.py:43-55`)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    """Rotation matrix -> quaternion (wxyz); inverse of qvec2rotmat."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


def read_cameras_binary(path) -> dict:
    from gsplat_tpu_torch.data import native

    nat = native.colmap_cameras(path)
    if nat is not None:
        out = {}
        for cam_id, (model_id, width, height, params) in nat.items():
            name, n_params = CAMERA_MODELS[model_id]
            out[cam_id] = ColmapCamera(cam_id, name, width, height, params[:n_params])
        return out
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    out = {}
    for _ in range(num):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, n_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(data, dtype="<f8", count=n_params, offset=off).copy()
        off += 8 * n_params
        out[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return out


def read_images_binary(path) -> dict:
    from gsplat_tpu_torch.data import native

    nat = native.colmap_images(path)
    if nat is not None:
        empty_xys = np.zeros((0, 2))
        empty_ids = np.zeros((0,), np.int64)
        return {
            iid: ColmapImage(iid, qvec, tvec, cam_id, name, empty_xys, empty_ids)
            for iid, (qvec, tvec, cam_id, name) in nat.items()
        }
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    out = {}
    for _ in range(num):
        image_id = struct.unpack_from("<i", data, off)[0]
        off += 4
        qt = np.frombuffer(data, dtype="<f8", count=7, offset=off).copy()
        off += 56
        (camera_id,) = struct.unpack_from("<i", data, off)
        off += 4
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (n_pts,) = struct.unpack_from("<Q", data, off)
        off += 8
        rec = np.frombuffer(data, dtype="<f8", count=3 * n_pts, offset=off)
        xys = rec.reshape(-1, 3)[:, :2].copy()
        ids = (
            np.frombuffer(data, dtype="<i8", count=3 * n_pts, offset=off)
            .reshape(-1, 3)[:, 2]
            .copy()
        )
        off += 24 * n_pts
        out[image_id] = ColmapImage(image_id, qt[:4], qt[4:], camera_id, name, xys, ids)
    return out


def read_points3d_binary(path):
    """-> (xyz (N,3) f64, rgb (N,3) u8, error (N,)) like `colmap_loader.py:125`."""
    from gsplat_tpu_torch.data import native

    nat = native.colmap_points3d(path)
    if nat is not None:
        return nat
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num,), np.float64)
    for i in range(num):
        # id(8) xyz(24) rgb(3) error(8) = 43 bytes fixed header
        xyz[i] = np.frombuffer(data, "<f8", count=3, offset=off + 8)
        rgb[i] = np.frombuffer(data, "u1", count=3, offset=off + 32)
        err[i] = struct.unpack_from("<d", data, off + 35)[0]
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        off += 51 + 8 * track_len
    return xyz, rgb, err


def read_cameras_text(path) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            out[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return out


def read_images_text(path) -> dict:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if not l.startswith("#")]
    # pairing mirrors the reference's readline loop: blank lines are
    # skipped EXCEPT the one immediately following an image header (an
    # image with zero 2D points has an empty points line), so stray
    # blank lines elsewhere can't shift the 2-line pairing
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        i += 2
        xys = np.array([float(x) for x in elems], dtype=np.float64)
        if xys.size:
            xys = xys.reshape(-1, 3)
            pids = xys[:, 2].astype(np.int64)
            xys = xys[:, :2]
        else:
            xys = np.zeros((0, 2))
            pids = np.zeros((0,), np.int64)
        out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, pids)
    return out


def write_cameras_binary(cameras: dict, path) -> None:
    """Inverse of `read_cameras_binary` (reference
    `utils/read_write_model.py:133-148` write_cameras_binary)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = _NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_cameras_text(cameras: dict, path) -> None:
    """Inverse of `read_cameras_text` (`read_write_model.py:106-131`)."""
    with open(path, "w") as f:
        f.write(
            "# Camera list with one line of data per camera:\n"
            "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
            f"# Number of cameras: {len(cameras)}\n"
        )
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_binary(images: dict, path) -> None:
    """Inverse of `read_images_binary` (`read_write_model.py:236-256`)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3d_ids)
            f.write(struct.pack("<Q", n))
            rec = np.empty((n, 3), "<f8")
            rec[:, :2] = im.xys
            # point3D ids ride the double column bit-for-bit (the format
            # interleaves f64 xy with i64 id per 2D point)
            rec[:, 2:3].view("<i8")[:, 0] = np.asarray(im.point3d_ids, "<i8")
            f.write(rec.tobytes())


def write_images_text(images: dict, path) -> None:
    """Inverse of `read_images_text` (`read_write_model.py:207-234`)."""
    mean_obs = (
        sum(len(im.point3d_ids) for im in images.values()) / len(images)
        if images
        else 0.0
    )
    with open(path, "w") as f:
        f.write(
            "# Image list with two lines of data per image:\n"
            "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
            "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
            f"# Number of images: {len(images)}, mean observations per image: {mean_obs}\n"
        )
        for im in images.values():
            head = [im.id, *im.qvec, *im.tvec, im.camera_id, im.name]
            f.write(" ".join(map(str, head)) + "\n")
            pts = [
                f"{x} {y} {pid}"
                for (x, y), pid in zip(im.xys, im.point3d_ids)
            ]
            f.write(" ".join(pts) + "\n")


def write_points3d_binary(xyz, rgb, err, path, ids=None, tracks=None) -> None:
    """Inverse of `read_points3d_binary` (`read_write_model.py:338-352`).

    `ids` defaults to 1..N; `tracks` is an optional list of (image_id,
    point2d_idx) int arrays per point (written empty when absent — the
    subset our reader consumes ignores tracks by design)."""
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    err = np.asarray(err, np.float64)
    n = len(xyz)
    if ids is None:
        ids = np.arange(1, n + 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<Q", int(ids[i])))
            f.write(xyz[i].astype("<f8").tobytes())
            f.write(rgb[i].astype("u1").tobytes())
            f.write(struct.pack("<d", float(err[i])))
            track = tracks[i] if tracks is not None else ()
            f.write(struct.pack("<Q", len(track)))
            for img_id, p2d_idx in track:
                f.write(struct.pack("<ii", int(img_id), int(p2d_idx)))


def write_points3d_text(xyz, rgb, err, path, ids=None, tracks=None) -> None:
    """Inverse of `read_points3d_text` (`read_write_model.py:304-336`)."""
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    err = np.asarray(err, np.float64)
    n = len(xyz)
    if ids is None:
        ids = np.arange(1, n + 1)
    with open(path, "w") as f:
        f.write(
            "# 3D point list with one line of data per point:\n"
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            f"# Number of points: {n}, mean track length: 0\n"
        )
        for i in range(n):
            track = tracks[i] if tracks is not None else ()
            tail = " ".join(f"{int(a)} {int(b)}" for a, b in track)
            f.write(
                f"{int(ids[i])} {xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]} "
                f"{rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]} {err[i]}"
                + (f" {tail}" if tail else "")
                + "\n"
            )


def write_model(cameras: dict, images: dict, points, path, ext=".bin") -> None:
    """Write a full sparse model dir (cameras/images/points3D), `.bin` or
    `.txt` — the reference's `write_model` (`read_write_model.py:446-458`).
    `points` is the reader's (xyz, rgb, err) triple."""
    import os

    os.makedirs(path, exist_ok=True)
    xyz, rgb, err = points
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(xyz, rgb, err, os.path.join(path, "points3D.bin"))
    elif ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3d_text(xyz, rgb, err, os.path.join(path, "points3D.txt"))
    else:
        raise ValueError(f"ext must be '.bin' or '.txt', got {ext!r}")


def read_points3d_text(path):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz_l.append([float(x) for x in parts[1:4]])
            rgb_l.append([int(x) for x in parts[4:7]])
            err_l.append(float(parts[7]))
    return (
        np.asarray(xyz_l, np.float64),
        np.asarray(rgb_l, np.uint8),
        np.asarray(err_l, np.float64),
    )
