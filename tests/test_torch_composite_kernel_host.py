"""The composite kernels' CUDA source (`gsplat_tpu_torch/csrc/composite.cu`)
run on the host, through the wrappers `composite_fwd` and `composite_bwd`,
against the plain twins `composite_torch` and `composite_bwd_torch` bit
for bit.

The source is built with `g++ -O2 -ffp-contract=off` against the fiber stub
of `tests/test_torch_loss_kernel_host.py` (each launch a loop over the
blocks, a block's threads as fibers, shuffles behind a warp barrier, the
dynamic shared memory NaN-filled before each block). The kernels use + - *
/ in float32 (and + in double), fminf/fmaxf on values that are not signed
zeros, which round the same on the host.

Frames: a crop edge in both axes (100 x 70: 7 x 5 tiles), one tile (16 x
16) and a crop inside one tile (9 x 5), three forward blocks or more per
axis, and 19 x 17 tiles (more tiles than the exposure sum's 256 lanes);
sorted and OIT, with and without exposure, the exposure's gradient wanted
or not, incoming gradients present or None. Pre-clamp values of exactly 0
and 1, values outside [0, 1] and OIT denominators at, under and over the
1e-8 floor are in every frame. The backward's counter of finished blocks
must be zero again after each launch.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import composite as cp
from tests.test_torch_loss_kernel_host import DYNAMIC_SMEM, LAUNCH, STUB

BG = (0.25, 0.5, 0.75)
# W x H: a crop edge on both axes; one tile; a crop inside one tile; more
# than 256 tiles
SIZES = ((100, 70), (16, 16), (9, 5), (300, 260))


def host_source(src: str) -> str:
    """composite.cu for g++: each launch a call of the stub's launcher, the
    dynamic shared memory the stub's buffer."""
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    src, smem = DYNAMIC_SMEM.subn(r"#define \1 gs_host_smem", src)
    assert launches == 2 and smem == 1, (launches, smem)
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("composite_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "composite_host.cpp").write_text(
        host_source((_kernels.CSRC / "composite.cu").read_text()))
    out = tmp / "libcomposite_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++20",
                    "-shared", "-fPIC", "-pthread", "-w", "-I", str(tmp), "-o", str(out),
                    str(tmp / "composite_host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _kernels._SIGNATURES["composite"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_lib)
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for w in (cp.composite_fwd, cp.composite_bwd):
        monkeypatch.setattr(w, "launches", w.launches)


def raw_frame(mode, w, h, seed):
    """A blend output (T, 256, 8) with the composite's edge values: colours
    and T that put pre-clamp values at exactly 0 and 1 and outside [0, 1];
    OIT denominators of 0, the 1e-8 floor itself and around it."""
    gx, gy = -(-w // 16), -(-h // 16)
    rng = np.random.default_rng(seed)
    raw = np.zeros((gx * gy, 256, 8), np.float32)
    if mode == "sorted":
        raw[..., 0:3] = rng.uniform(-0.2, 1.2, (gx * gy, 256, 3))
        raw[..., 3] = rng.uniform(0.0, 3.0, (gx * gy, 256))
        raw[..., 4] = rng.uniform(0.0, 1.0, (gx * gy, 256))
        raw[:, 0::7, 4] = 0.0  # c + 0 * bg: the pre-clamp value is c
        raw[:, 0::7, 0:3] = rng.choice(np.float32([0.0, 1.0, 0.5]), (gx * gy, 37, 3))
        raw[..., 5] = rng.integers(0, 40, (gx * gy, 256))
    else:
        raw[..., 0:4] = rng.uniform(0.0, 2.0, (gx * gy, 256, 4))
        raw[..., 4] = rng.uniform(0.0, 2.0, (gx * gy, 256))
        raw[..., 5] = rng.uniform(0.01, 1.0, (gx * gy, 256))
        raw[:, 1::11, 4] = rng.choice(np.float32([0.0, 1e-8, 5e-9, 2e-8]), (gx * gy, 24))
        # T = 0 and D = 1: w = 1, the pre-clamp value N, at exactly 0 and 1
        raw[:, 3::13, 4:6] = (1.0, 0.0)
        raw[:, 3::13, 0:3] = rng.choice(np.float32([0.0, 1.0, 0.5]), (gx * gy, 20, 3))
    return torch.from_numpy(raw), gx, gy


def grads(w, h, seed, which):
    """Seeded incoming gradients, every fifth value -0.0 (autograd's sum
    turns it into +0.0); those not in `which` None."""
    rng = np.random.default_rng(seed + 1)
    shapes = {"d_render": (h, w, 3), "d_invdepth": (h, w), "d_final_t": (h, w)}
    out = {}
    for k, s in shapes.items():
        g = rng.standard_normal(s).astype(np.float32)
        g.reshape(-1)[::5] = -0.0
        out[k] = torch.from_numpy(g) if k in which else None
    return out


def exposure_of(seed):
    rng = np.random.default_rng(seed + 2)
    e = np.eye(3, 4, dtype=np.float32) * np.float32(1.1)
    e += rng.uniform(-0.1, 0.1, (3, 4)).astype(np.float32)
    return torch.from_numpy(e)


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("mode", cp.MODES)
@pytest.mark.parametrize("w,h", SIZES)
def test_composite_kernels_on_the_host_equal_their_twins(on_host, mode, w, h):
    raw, gx, gy = raw_frame(mode, w, h, w * 1000 + h)
    bg = torch.tensor(BG)
    big = w * h > 10_000  # the largest frame: the backward's summed exposure gradient alone
    # as training calls it; all three; final T alone, the exposure's
    # gradient of zeros
    cases = ((("d_render", "d_invdepth"), True),
             (("d_render", "d_invdepth", "d_final_t"), False), (("d_final_t",), True))
    for exposure in (exposure_of(w + h),) if big else (None, exposure_of(w + h)):
        args = (raw, mode, bg, exposure, gx, gy, 16, w, h)
        if not big:
            got, want = cp.composite_fwd(*args), cp.composite_torch(*args)
            for name, a, b in zip(("render", "invdepth", "final_t"), got, want):
                assert torch.equal(bits(a), bits(b)), (exposure is not None, name)
        for which, want_exposure in cases[:1] if big else cases:
            g = grads(w, h, w + h, which)
            cot, dexp = cp.composite_bwd(*args, **g, want_exposure=want_exposure)
            cot_t, dexp_t = cp.composite_bwd_torch(*args, **g, want_exposure=want_exposure)
            case = (exposure is not None, which, want_exposure)
            assert torch.equal(bits(cot), bits(cot_t)), case
            assert (dexp is None) == (dexp_t is None), case
            if dexp is not None:
                assert torch.equal(bits(dexp), bits(dexp_t)), case
            assert int(cp._ticket(raw.device)) == 0, case


def test_the_kernels_refuse_a_frame_that_is_not_theirs(on_host):
    raw, gx, gy = raw_frame("sorted", 100, 70, 0)
    with pytest.raises(ValueError):
        cp.composite_fwd(raw, "sorted", torch.tensor(BG), None, gx, gy - 1, 16, 100, 70)
    with pytest.raises(RuntimeError):  # the grid does not cover the image
        cp.composite_fwd(raw.reshape(gy, gx, 256, 8).transpose(0, 1).reshape(-1, 256, 8),
                         "sorted", torch.tensor(BG), None, gy, gx, 16, 100, 70)
