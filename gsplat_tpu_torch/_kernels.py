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
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("binning", "rasterize_fwd", "rasterize_bwd", "reduce", "rasterize_oit",
           "probe_skeleton", "probe_ops")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points; every pointer and the stream are void*
_SIGNATURES = {
    "binning": {
        "gs_expand_instances": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _P, _P, _P, _P),
        "gs_pack_instances": (_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P),
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
        "gs_skel_fwd": (_P, _LL, _P, _P, _I, _P, _P),
        "gs_skel_bwd": (_P, _LL, _P, _P, _I, _P, _P, _P, _P),
    },
    "probe_ops": {
        "gs_op_elementwise": (_I, _P, _P, _I, _I, _P),
        "gs_op_contract4": (_P, _P, _P, _I, _I, _I, _P),
        "gs_op_two_matmuls": (_P, _P, _P, _P, _P, _I, _I, _P),
        "gs_op_merged": (_P, _P, _P, _P, _I, _I, _I, _P),
        "gs_op_fwd_accum": (_P, _P, _P, _I, _I, _P),
        "gs_op_kappa": (_P, _P, _P, _I, _I, _I, _P),
        "gs_blend_mix_f32": (_P, _P, _I, _I, _P),
        "gs_blend_mix_bf16": (_P, _P, _I, _I, _P),
    },
}


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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    job = _start_build(name)
    if job is not None:
        _finish_build(job)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
