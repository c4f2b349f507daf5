"""ctypes bindings for the native host runtime (`native/gsplat_native.cpp`).

Copy of `gsplat_tpu/data/native.py`: the native library parses the hot IO
paths (binary PLY into SoA float32, the COLMAP binary model), the
data-loader layer the reference keeps in C++. The codecs in `data/ply.py`
and `data/colmap.py` fall back to their Python parsers when the library
cannot be built or a file uses a format the native path does not cover
(ascii PLY).

The port builds its own copy of the library, from the unchanged source,
into `gsplat_tpu_torch/_build/libgsplat_native-<hash>.so` (the hash covers
the source and the flags) on first use. The build is atomic: `g++` writes a
temporary file in the build directory, which `os.replace` moves into place,
under an exclusive `fcntl` lock, so processes that load the library at once
(test workers) wait for one build and never open a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gsplat_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# `native/Makefile`'s flags without `-march=native`: the build directory
# may outlive the machine it was built on (a checkout on a shared disk), and
# the parsers copy and convert values, with no arithmetic the target changes
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")


def library_path() -> Path:
    """Build output for the source, keyed by its bytes and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgsplat_native-{digest}.so"


def build() -> Path:
    """The built library, compiled first if it is missing (see the module
    docstring for why the build is locked and atomic)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libgsplat_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                                str(SOURCE)], capture_output=True, timeout=120, check=True)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load():
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        print(f"gsplat_tpu_torch: native IO library unavailable ({e}); "
              "using the Python parsers", file=sys.stderr)
        return None

    lib.gsplat_last_error.restype = ctypes.c_char_p
    lib.gsplat_last_error.argtypes = []
    lib.gsplat_ply_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gsplat_ply_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gsplat_colmap_points3d.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gsplat_colmap_images.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,
    ]
    lib.gsplat_colmap_cameras.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    for fn in ("gsplat_ply_read", "gsplat_ply_write", "gsplat_colmap_points3d",
               "gsplat_colmap_images", "gsplat_colmap_cameras"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ply_read_columns(path):
    """Native PLY vertex parse -> (names list, dict name -> (N,) float32).

    Returns None if the native path is unavailable/unsupported for this file.
    """
    lib = _load()
    if lib is None:
        return None
    n_vert = ctypes.c_int64()
    n_props = ctypes.c_int32()
    name_buf = ctypes.create_string_buffer(16384)
    rc = lib.gsplat_ply_read(
        path.encode(), ctypes.byref(n_vert), ctypes.byref(n_props),
        name_buf, len(name_buf), None,
    )
    if rc != 0:
        return None
    names = name_buf.value.decode().split(",")
    out = np.empty((n_props.value, n_vert.value), np.float32)
    rc = lib.gsplat_ply_read(
        path.encode(), ctypes.byref(n_vert), ctypes.byref(n_props),
        name_buf, len(name_buf), _fptr(out),
    )
    if rc != 0:
        return None
    return names, {nm: out[i] for i, nm in enumerate(names)}


def ply_write_columns(path, names, cols) -> bool:
    """Native all-float PLY write; cols is (P, N) float32."""
    lib = _load()
    if lib is None:
        return False
    cols = np.ascontiguousarray(cols, np.float32)
    rc = lib.gsplat_ply_write(
        path.encode(), cols.shape[1], cols.shape[0], ",".join(names).encode(), _fptr(cols)
    )
    return rc == 0


def colmap_points3d(path):
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    if lib.gsplat_colmap_points3d(path.encode(), ctypes.byref(n), None, None, None) != 0:
        return None
    xyz = np.empty((n.value, 3), np.float32)
    rgb = np.empty((n.value, 3), np.uint8)
    err = np.empty((n.value,), np.float32)
    rc = lib.gsplat_colmap_points3d(
        path.encode(), ctypes.byref(n), _fptr(xyz),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(err),
    )
    if rc != 0:
        return None
    return xyz, rgb, err


def colmap_images(path):
    """-> dict image_id -> (qvec, tvec, camera_id, name), or None."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    nl = ctypes.c_int64()
    if lib.gsplat_colmap_images(path.encode(), ctypes.byref(n), ctypes.byref(nl), None, None, None) != 0:
        return None
    qt = np.empty((n.value, 7), np.float32)
    ids = np.empty((n.value, 2), np.int32)
    names_buf = ctypes.create_string_buffer(nl.value + 1)
    rc = lib.gsplat_colmap_images(
        path.encode(), ctypes.byref(n), ctypes.byref(nl), _fptr(qt),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), names_buf,
    )
    if rc != 0:
        return None
    names = names_buf.raw[: nl.value].decode().split("\n")[: n.value]
    return {
        int(ids[i, 0]): (
            qt[i, :4].astype(np.float64),
            qt[i, 4:].astype(np.float64),
            int(ids[i, 1]),
            names[i],
        )
        for i in range(n.value)
    }


def colmap_cameras(path):
    """-> dict camera_id -> (model_id, width, height, params), or None."""
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    if lib.gsplat_colmap_cameras(path.encode(), ctypes.byref(n), None) != 0:
        return None
    out = np.empty((n.value, 12), np.float32)
    if lib.gsplat_colmap_cameras(path.encode(), ctypes.byref(n), _fptr(out)) != 0:
        return None
    return {
        int(out[i, 0]): (
            int(out[i, 1]), int(out[i, 2]), int(out[i, 3]), out[i, 4:].astype(np.float64)
        )
        for i in range(n.value)
    }
