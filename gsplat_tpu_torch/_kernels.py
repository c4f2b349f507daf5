"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with `ctypes`. Nothing happens at
import: the first `load(name)` builds (or finds) the library, so importing
the package needs neither `nvcc` nor a GPU. `build_all()` starts one `nvcc`
per source at once and waits for all of them.

Libraries go to `gsplat_tpu_torch/_build/`, named by a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and a stale one never loaded.

Flags: `-fmad=false`, never `--use_fast_math`. The blend's keep rule
(alpha >= 1/255) and the binning's bit-equality with the JAX package hang on
float32 rounding in a fixed association order, which FMA contraction would
change.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("binning", "sort", "sort_onesweep", "rasterize_fwd", "rasterize_bwd", "reduce",
           "rasterize_oit", "probe_skeleton", "probe_ops", "projection", "adam", "loss",
           "composite")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points; every pointer and the stream are void*
_SIGNATURES = {
    "binning": {
        "gs_emission_layout": (_LL, _P),
        "gs_emission_tables": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P, _LL, _LL, _P),
        "gs_expand_instances": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _P, _P, _P, _P),
        "gs_pack_instances": (_P, _P, _P, _LL, _I, _I, _P, _P, _P, _P),
    },
    "sort": {
        "gs_sort_layout": (_LL, _I, _P),
        "gs_sort_instances": (_P, _P, _LL, _I, _P, _P, _P, _P, _LL, _P),
    },
    "sort_onesweep": {
        "gs_sort_layout": (_LL, _I, _P),
        "gs_sort_instances": (_P, _P, _LL, _I, _P, _P, _P, _P, _P, _LL, _LL, _P),
    },
    "rasterize_fwd": {
        "gs_blend_fwd": (_P, _LL, _P, _P, _I, _I, _I, _P, _P),
    },
    "rasterize_bwd": {
        "gs_blend_bwd": (_P, _LL, _P, _P, _I, _I, _P, _P, _P, _P),
    },
    "reduce": {
        "gs_reduce_by_gid": (_P, _P, _LL, _I, _P, _P),
        "gs_red_forms": (_P, _LL, _I, _P, _P),
    },
    "rasterize_oit": {
        "gs_oit_fwd": (_P, _LL, _P, _P, _I, _I, _P, _P),
        "gs_oit_bwd": (_P, _LL, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    },
    "probe_skeleton": {
        "gs_skel_fwd": (_P, _LL, _I, _P, _P, _I, _P, _P),
        "gs_skel_fwd_info": (_P,),
        "gs_skel_bwd": (_P, _LL, _P, _P, _I, _P, _P, _P, _P),
    },
    # the P3' kernels take a `sink` pointer after their output: the others'
    # checksums, `k_div`'s report of its IEEE-division rerun; those after
    # the elementwise ones no longer take the fed-back row
    "probe_ops": {
        "gs_op_elementwise": (_I, _P, _P, _P, _I, _I, _P),
        "gs_rcp_check": (_P, _P, _I, _P),
        "gs_op_contract4": (_P, _P, _P, _P, _I, _I, _P),
        "gs_op_two_matmuls": (_P, _P, _P, _P, _P, _P, _I, _P),
        "gs_op_merged": (_P, _P, _P, _P, _P, _I, _P),
        "gs_op_fwd_accum": (_P, _P, _P, _P, _I, _P),
        "gs_op_kappa": (_P, _P, _P, _P, _I, _I, _P),
        "gs_blend_mix_f32": (_P, _P, _I, _I, _P),
        "gs_blend_mix_bf16": (_P, _P, _I, _I, _I, _P),
        "gs_sm_clock": (_P, _LL, _P),
        "gs_probe_loop_shape": (_P, _I),
    },
    # the argument blocks are the structures below, passed by pointer
    "projection": {
        "gs_project_fwd": (_P, _P, _I, _I, _I, _P),
        "gs_project_bwd": (_P, _P, _P, _I, _I, _P),
    },
    "adam": {"gs_adam_rows": (_P, _P)},
    "loss": {"gs_loss_fwd": (_P, _P), "gs_loss_bwd": (_P, _P), "gs_loss_info": (_P,)},
    "composite": {"gs_composite_fwd": (_P, _P), "gs_composite_bwd": (_P, _P)},
}


def _struct(name, fields):
    return type(name, (ctypes.Structure,), {"_fields_": fields})


# the projection kernels' argument blocks (`csrc/projection.cu`), field for
# field; a pointer left None is NULL
ProjectParams = _struct("ProjectParams", [
    *((f, _P) for f in ("xyz", "scaling", "rotation", "opacity", "features_dc",
                        "features_rest", "mean2d_offset", "alive", "world_view",
                        "full_proj", "camera_center", "tan_fovx", "tan_fovy")),
    ("n", _LL), *((f, _I) for f in ("k_rest", "width", "height", "grid_x", "grid_y", "tile")),
    ("scale_modifier", ctypes.c_float)])
ProjectOutputs = _struct("ProjectOutputs", [(f, _P) for f in (
    "mean2d", "conic", "opacity", "rgb", "depth", "radius", "cull_qmax", "rect_min",
    "rect_max", "tiles_touched", "mask")])
# each cotangent with its strides in elements (row, column)
ProjectCotangents = _struct("ProjectCotangents", [
    item for f in ("mean2d", "conic", "opacity", "rgb", "depth")
    for item in ((f, _P), (f"{f}_s0", _LL), (f"{f}_s1", _LL))])
ProjectGrads = _struct("ProjectGrads", [(f, _P) for f in (
    "xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest", "mean2d_offset")])

# the Adam kernel's argument block (`csrc/adam.cu`): up to ADAM_MAX_FIELDS
# fields, each p, g, m, v and the three outputs, g's row stride in elements,
# the row width and the learning rate
ADAM_MAX_FIELDS = 8
AdamField = _struct("AdamField", [
    *((f, _P) for f in ("p", "g", "m", "v", "p_out", "m_out", "v_out")),
    ("g_stride", _LL), ("width", _I), ("lr", ctypes.c_float)])
AdamArgs = _struct("AdamArgs", [
    ("field", AdamField * ADAM_MAX_FIELDS),
    *((f, _P) for f in ("counts", "counts_out", "visibility", "alive")),
    ("n", _LL), ("n_fields", _I), ("eps", ctypes.c_float)])

# the loss kernels' argument blocks (`csrc/loss.cu`); a pointer left None is
# NULL; `ticket` is the forward's zeroed counter of finished blocks
LOSS_TAPS = 11
LossFwdArgs = _struct("LossFwdArgs", [
    *((f, _P) for f in ("x", "y", "px", "py", "block_sums", "loss", "l1", "ssim", "ticket")),
    ("h", _I), ("w", _I), ("taps", ctypes.c_float * LOSS_TAPS),
    *((f, ctypes.c_float) for f in ("c1", "c2", "lam", "olam"))])
LossBwdArgs = _struct("LossBwdArgs", [
    *((f, _P) for f in ("a", "b", "partials", "g_loss", "g_l1", "g_ssim", "grad")),
    ("h", _I), ("w", _I), ("taps", ctypes.c_float * LOSS_TAPS),
    *((f, ctypes.c_float) for f in ("lam", "olam", "inv_n"))])

# the composite kernels' argument blocks (`csrc/composite.cu`); a pointer
# left None is NULL (no exposure, a zero incoming gradient, no exposure
# gradient); `oit` is 0 (sorted) or 1
_COMPOSITE_DIMS = [(f, _I) for f in ("grid_x", "grid_y", "width", "height", "oit")]
CompositeFwdArgs = _struct("CompositeFwdArgs", [
    *((f, _P) for f in ("raw", "bg", "exposure", "render", "invdepth", "final_t")),
    *_COMPOSITE_DIMS])
CompositeBwdArgs = _struct("CompositeBwdArgs", [
    *((f, _P) for f in ("raw", "bg", "exposure", "d_render", "d_invdepth", "d_final_t", "cot",
                        "partials", "d_exposure", "ticket")),
    *_COMPOSITE_DIMS])


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Build output for `csrc/<name>.cu`, keyed by its source, every shared
    header under `csrc/` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def build_all(names=SOURCES) -> None:
    """Build every named source, one nvcc each, all started together."""
    jobs = [job for job in (_start_build(n) for n in names) if job is not None]
    errors = []
    for job in jobs:
        try:
            _finish_build(job)
        except RuntimeError as e:  # collect, so every nvcc is waited on
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def open_library(path: Path, name: str) -> ctypes.CDLL:
    """A built library of `csrc/<name>.cu` (or of a variant of it), its
    entry points bound to their signatures."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    job = _start_build(name)
    if job is not None:
        _finish_build(job)
    return open_library(library_path(name), name)


def res_usage(path: Path) -> dict:
    """{kernel function: {REG, STACK, SHARED, LOCAL}} of a built library,
    from `cuobjdump -res-usage` (a spill shows in STACK and LOCAL)."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-res-usage", str(path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    keys = ("REG", "STACK", "SHARED", "LOCAL")
    return {m.group(1): dict(zip(keys, map(int, m.groups()[1:])))
            for m in re.finditer(r"Function\s+(\S+?):\s+REG:(\d+)\s+STACK:(\d+)\s+"
                                 r"SHARED:(\d+)\s+LOCAL:(\d+)", text)}


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
