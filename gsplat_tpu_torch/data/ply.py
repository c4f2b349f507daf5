"""Self-contained PLY codec (no external plyfile dependency).

Copy of `gsplat_tpu/data/ply.py` without the native C++ fast path (that
belongs to the data slice).

Supports the two layouts the reference uses:
- simple point clouds (x/y/z, nx/ny/nz, red/green/blue u1) as written by
  `storePly` and read by `fetchPly` (reference `scene/dataset_readers.py:120-143`),
- the Gaussian model snapshot layout written by `GaussianModel.save_ply`
  (reference `scene/gaussian_model.py:225-256`): x,y,z, nx,ny,nz, f_dc_*,
  f_rest_*, opacity, scale_*, rot_* — all float32, binary little-endian.
  Keeping this layout byte-compatible makes our checkpoints loadable by the
  reference's viewers and vice versa.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyElementData:
    name: str
    count: int
    data: np.ndarray  # structured array


def read_ply_columns(path):
    """Vertex element as {prop_name: (N,) float32}, by the Python parser."""
    v = read_ply(path)["vertex"]
    return {nm: np.asarray(v[nm], np.float32) for nm in v.dtype.names}


def read_ply(path) -> dict:
    """Parse a PLY file -> {element_name: structured ndarray}.

    Handles binary_little_endian and ascii formats (the only ones the
    reference ecosystem emits).
    """
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = raw[:header_end].decode("ascii", errors="replace").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing ply magic")

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("list properties not supported")
            elements[-1][2].append((parts[-1], _PLY_TO_NP[parts[1]]))

    out = {}
    if fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            dtype = np.dtype([(p, "<" + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
            out[name] = arr
    elif fmt == "ascii":
        text = body.decode("ascii")
        rows = [r.split() for r in text.splitlines() if r.strip()]
        cursor = 0
        for name, count, props in elements:
            dtype = np.dtype([(p, t) for p, t in props])
            arr = np.zeros(count, dtype=dtype)
            for i in range(count):
                vals = rows[cursor + i]
                for (p, t), v in zip(props, vals):
                    arr[p][i] = float(v) if t.startswith("f") else int(float(v))
            cursor += count
            out[name] = arr
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return out


def write_ply(path, elements: dict) -> None:
    """Write {element_name: structured ndarray} as binary_little_endian PLY."""
    _NP_TO_PLY = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
                  "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    for name, arr in elements.items():
        buf.write(f"element {name} {len(arr)}\n".encode())
        for field in arr.dtype.names:
            kind = arr.dtype[field].str.lstrip("<>|=")
            buf.write(f"property {_NP_TO_PLY[kind]} {field}\n".encode())
    buf.write(b"end_header\n")
    for name, arr in elements.items():
        le = arr.astype(
            np.dtype([(f, arr.dtype[f].str.replace(">", "<")) for f in arr.dtype.names]),
            copy=False,
        )
        buf.write(le.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_point_cloud(path):
    """(points (N,3) f32, colors (N,3) in [0,1], normals (N,3)) like fetchPly."""
    ply = read_ply(path)
    v = ply["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if "red" in v.dtype.names:
        denom = 255.0 if v.dtype["red"].kind == "u" else 1.0
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32) / denom
    else:
        colors = np.full_like(pts, 0.5)
    if "nx" in v.dtype.names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def write_point_cloud(path, xyz, rgb_u8) -> None:
    """storePly-compatible point cloud (normals zeroed)."""
    n = xyz.shape[0]
    arr = np.zeros(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rgb = np.clip(rgb_u8, 0, 255).astype(np.uint8)
    arr["red"], arr["green"], arr["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    write_ply(path, {"vertex": arr})


def gaussian_attribute_names(n_rest: int):
    """Attribute order of the reference snapshot layout
    (`gaussian_model.py:225-237` construct_list_of_attributes)."""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest * 3)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(path, xyz, features_dc, features_rest, opacity, scaling, rotation):
    """Write model params in the reference's snapshot layout.

    Args are numpy, pre-activation, shapes (N,3), (N,1,3), (N,R,3), (N,1),
    (N,3), (N,4). SH features are flattened channel-major ((N, 3*R) with the
    channel axis fastest-varying over bands transposed) exactly like
    `save_ply` (`gaussian_model.py:239-249`: .transpose(1, 2).flatten — i.e.
    (N, C, B) order).
    """
    n = xyz.shape[0]
    f_dc = np.ascontiguousarray(np.swapaxes(features_dc, 1, 2)).reshape(n, -1)
    f_rest = np.ascontiguousarray(np.swapaxes(features_rest, 1, 2)).reshape(n, -1)
    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity.reshape(n, -1), scaling, rotation],
        axis=1,
    ).astype(np.float32)
    names = gaussian_attribute_names(features_rest.shape[1])
    arr = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    for i, nm in enumerate(names):
        arr[nm] = cols[:, i]
    write_ply(path, {"vertex": arr})


def load_gaussian_ply(path):
    """Read a reference-layout snapshot -> dict of pre-activation numpy arrays.

    Mirrors `load_ply` (`gaussian_model.py:271-314`) including the sorted
    f_rest index ordering and the (N, 3, B) -> (N, B, 3) transpose.
    """
    v = read_ply_columns(path)
    names = list(v.keys())
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=-1).astype(np.float32)[:, None, :]

    rest_names = sorted(
        (nm for nm in names if nm.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    n_rest3 = len(rest_names)
    assert n_rest3 % 3 == 0
    bands = n_rest3 // 3
    f_rest = np.stack([v[nm] for nm in rest_names], axis=-1).astype(np.float32)
    f_rest = f_rest.reshape(n, 3, bands).transpose(0, 2, 1)  # (N, B, 3)

    scale_names = sorted((nm for nm in names if nm.startswith("scale_")), key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((nm for nm in names if nm.startswith("rot_")), key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([v[nm] for nm in scale_names], axis=-1).astype(np.float32)
    rotation = np.stack([v[nm] for nm in rot_names], axis=-1).astype(np.float32)
    return {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": f_rest,
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }
