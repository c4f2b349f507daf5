"""The loss kernels' CUDA source (`gsplat_tpu_torch/csrc/loss.cu`) run on the
host, through the wrappers `loss_fwd` and `loss_bwd`, against the plain
twins `loss_fwd_torch` and `loss_bwd_torch` bit for bit.

The source is built with `g++ -O2 -ffp-contract=off` (no contraction, as
`-fmad=false` on the card) against a stub `cuda_runtime.h` written here:
each launch `kernel<<<grid, block, smem, stream>>>(args)` rewritten to a
loop over the blocks, a block's threads run as fibers (`ucontext`) on one
host thread, each until it waits at `__syncthreads` or `__syncwarp` (a
shuffle is a slot array behind a warp barrier), a barrier opening when
every live thread of its block or warp waits at it. The dynamic shared
memory is filled with NaN before each block, so a value read before it
was written shows in the outputs; a launch that asks for more than 48 KB
of it without the kernel's attribute is refused, as on the card. The
kernels use only + - * / and `fabsf` in float32 (and + in double), which
round the same on the host, so the partial maps, the means and the
gradients equal the twins' bit for bit.

Sizes: smaller than the window (11x5), one 16x16 tile of the means, the
forward's 64x16 tile and the backward's 64x24 tile +-1 on each axis, a
width smaller than the halo, and three blocks or more per axis; the
forward runs twice on each (with both images' partials, then as training
runs it, the image's alone), so its counter of finished blocks must be
zero again after each launch. The card runs the same checks at full size
(`chip_smoke.py`'s `loss` phase).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.scripts import ablation, loss_ablate
from gsplat_tpu_torch.train import losses

LAMBDA = 0.2
TAPS = losses._window_taps(11, 1.5)

STUB = r"""
#pragma once
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct uint3 { unsigned x, y, z; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
    cudaFuncAttributeMaxDynamicSharedMemorySize,
    cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
typedef void* cudaStream_t;
struct cudaFuncAttributes { int numRegs; size_t sharedSizeBytes; };

alignas(16) inline float gs_host_smem[1 << 16];
inline std::map<const void*, int> gs_smem_allowed;
inline cudaError_t gs_last_error = cudaSuccess;
inline uint3 blockIdx, threadIdx;
inline dim3 gridDim, blockDim;

// a block's threads as fibers on one host thread, each run until it waits
// at a barrier or ends; a barrier opens when every live thread of its
// block (or warp) waits at it
enum { GS_RUN, GS_BLOCK, GS_WARP, GS_DONE };
struct GsFiber { ucontext_t ctx; int state; };
inline ucontext_t gs_sched;
inline std::vector<GsFiber> gs_fibers;
inline int gs_tid;
inline std::function<void()> gs_body;
inline float gs_slot[2][1024];
inline int gs_parity[1024];

inline void gs_wait(int state)
{
    gs_fibers[gs_tid].state = state;
    swapcontext(&gs_fibers[gs_tid].ctx, &gs_sched);
}
inline void __syncthreads() { gs_wait(GS_BLOCK); }
inline void __syncwarp(unsigned = 0xffffffffu) { gs_wait(GS_WARP); }
// two slot arrays in turns: a lane writes one only after every lane of its
// warp has read it at the shuffle before the last
inline float __shfl_down_sync(unsigned, float v, int d)
{
    const int t = gs_tid;
    float* slot = gs_slot[gs_parity[t] ^= 1];
    slot[t] = v;
    __syncwarp();
    return (t & 31) + d < 32 ? slot[t + d] : v;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p = o + v; return o; }
inline float __ldcg(const float* p) { return *p; }
inline float __ldg(const float* p) { return *p; }

inline cudaError_t cudaFuncSetAttribute(const void* f, cudaFuncAttribute attr, int v)
{
    if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) gs_smem_allowed[f] = v;
    return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d)
{
    *d = 0;
    return cudaSuccess;
}
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*)
{
    a->numRegs = 0;
    a->sharedSizeBytes = 0;
    return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int, size_t)
{
    *n = 0;
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError()
{
    const cudaError_t e = gs_last_error;
    gs_last_error = cudaSuccess;
    return e;
}

inline void gs_fiber_main()
{
    gs_body();
    gs_fibers[gs_tid].state = GS_DONE;
}

inline void gs_run_block(int n)
{
    static std::vector<char> stacks;
    const size_t stack = 64 * 1024;
    stacks.resize(n * stack);
    gs_fibers.assign(n, GsFiber{});
    for (int t = 0; t < n; ++t) {
        getcontext(&gs_fibers[t].ctx);
        gs_fibers[t].ctx.uc_stack.ss_sp = stacks.data() + t * stack;
        gs_fibers[t].ctx.uc_stack.ss_size = stack;
        gs_fibers[t].ctx.uc_link = &gs_sched;
        makecontext(&gs_fibers[t].ctx, gs_fiber_main, 0);
        gs_fibers[t].state = GS_RUN;
    }
    for (;;) {
        bool moved = false;
        for (int t = 0; t < n; ++t)
            if (gs_fibers[t].state == GS_RUN) {
                gs_tid = t;
                threadIdx = {(unsigned)t % blockDim.x, ((unsigned)t / blockDim.x) % blockDim.y,
                             (unsigned)t / (blockDim.x * blockDim.y)};
                swapcontext(&gs_sched, &gs_fibers[t].ctx);
                moved = true;
            }
        int live = 0, at_block = 0;
        for (int w = 0; w * 32 < n; ++w) {
            int wl = 0, at_warp = 0;
            for (int t = 32 * w; t < n && t < 32 * w + 32; ++t) {
                wl += gs_fibers[t].state != GS_DONE;
                at_warp += gs_fibers[t].state == GS_WARP;
                at_block += gs_fibers[t].state == GS_BLOCK;
            }
            live += wl;
            if (at_warp && at_warp == wl) {
                for (int t = 32 * w; t < n && t < 32 * w + 32; ++t) gs_fibers[t].state = GS_RUN;
                moved = true;
            }
        }
        if (!live) return;
        if (at_block == live) {
            for (auto& f : gs_fibers)
                if (f.state == GS_BLOCK) f.state = GS_RUN;
            moved = true;
        }
        if (!moved) std::abort();  // a barrier that never opens
    }
}

template <typename K, typename... A>
void gs_host_launch(K kernel, dim3 grid, dim3 block, int smem, A... args)
{
    const int allowed = gs_smem_allowed.count((const void*)kernel)
                            ? gs_smem_allowed[(const void*)kernel] : 48 * 1024;
    if (smem > allowed || smem > (int)sizeof gs_host_smem) {
        gs_last_error = cudaErrorInvalidValue;
        return;
    }
    gridDim = grid;
    blockDim = block;
    gs_body = [&] { kernel(args...); };
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            std::memset(gs_host_smem, 0xff, sizeof gs_host_smem);  // NaN
            blockIdx = {bx, by, 0};
            gs_run_block((int)(block.x * block.y * block.z));
        }
}
"""

LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(([^;]*)\);")
DYNAMIC_SMEM = re.compile(r"extern __shared__ __align__\(16\) float (\w+)\[\];")


def host_source(src: str) -> str:
    """loss.cu for g++: each launch a call of the stub's launcher, the
    dynamic shared memory the stub's buffer."""
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    src, smem = DYNAMIC_SMEM.subn(r"#define \1 gs_host_smem", src)
    assert launches >= 2 and smem == 1, (launches, smem)
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("loss_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "loss_host.cpp").write_text(host_source((_kernels.CSRC / "loss.cu").read_text()))
    out = tmp / "libloss_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++20",
                    "-shared", "-fPIC", "-pthread", "-w", "-I", str(tmp), "-o", str(out),
                    str(tmp / "loss_host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _kernels._SIGNATURES["loss"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_lib)
    monkeypatch.setattr(_kernels, "stream", lambda device: None)


def pair(seed, w, h):
    rng = np.random.default_rng(seed)
    x = rng.random((h, w, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal((h, w, 3)), 0.0, 1.0).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def bits(t):
    return t.contiguous().view(torch.int32)


# W x H: under the window; one means tile; the forward's tile (64 x 16) and
# the backward's (64 x 24) -1 and +1 on each axis; narrower than the halo;
# three blocks or more per axis of both kernels
SIZES = ((11, 5), (16, 16), (63, 15), (65, 17), (63, 23), (65, 25), (4, 40), (129, 65))


@pytest.mark.parametrize("w,h", SIZES)
def test_loss_kernels_on_the_host_equal_their_twins(on_host, w, h):
    x, y = pair(w * 1000 + h, w, h)
    want = losses.loss_fwd_torch(x, y, LAMBDA, True, True, TAPS)
    # both partials, then the image's alone: the ticket is zero after each
    for want_y in (True, False):
        got = losses.loss_fwd(x, y, LAMBDA, True, want_y, TAPS)
        for i, name in enumerate(("loss", "l1", "ssim", "px", "py")[:4 + want_y]):
            assert torch.equal(bits(got[i]), bits(want[i])), (want_y, name)
        assert int(losses._ticket(x.device)) == 0
        if want_y:
            both = got
    # the image's gradient with the train step's incoming gradient (the
    # others NULL), the ground truth's with all three
    one = torch.ones(())
    for a, b, part, grads in ((x, y, got[3], (one, None, None)),
                              (y, x, both[4], (one, 0.25 * one, -0.5 * one))):
        g = losses.loss_bwd(a, b, part, *grads, LAMBDA, TAPS)
        assert torch.equal(bits(g), bits(losses.loss_bwd_torch(a, b, part, *grads, LAMBDA, TAPS)))


def test_the_forward_without_partials_on_the_host(on_host):
    x, y = pair(3, 65, 17)
    got = losses.loss_fwd(x, y, LAMBDA, False, False, TAPS)
    want = losses.loss_fwd_torch(x, y, LAMBDA, False, False, TAPS)
    assert got[3] is None and got[4] is None
    for i in range(3):
        assert torch.equal(bits(got[i]), bits(want[i]))


def test_an_unaligned_image_on_the_host(on_host):
    """Images and partial maps that start 4, 8 and 12 bytes past a 16-byte
    boundary (the maps' planes 67 * 35 * 3 floats apart): the staging and
    the writers shift each row to its own."""
    x, y = pair(5, 67, 35)
    for off in (1, 2, 3):
        xs, ys = (torch.cat([torch.zeros(off), t.reshape(-1)])[off:].view(t.shape)
                  for t in (x, y))
        assert xs.data_ptr() % 16 == 4 * off
        got = losses.loss_fwd(xs, ys, LAMBDA, True, False, TAPS)
        want = losses.loss_fwd_torch(x, y, LAMBDA, True, False, TAPS)
        for i in (0, 1, 2, 3):
            assert torch.equal(bits(got[i]), bits(want[i]))
        part = torch.cat([torch.zeros(off), got[3].reshape(-1)])[off:].view(got[3].shape)
        g = losses.loss_bwd(xs, ys, part, torch.ones(()), None, None, LAMBDA, TAPS)
        assert torch.equal(bits(g), bits(losses.loss_bwd_torch(x, y, got[3], torch.ones(()),
                                                               None, None, LAMBDA, TAPS)))


@pytest.mark.parametrize("variant", sorted(loss_ablate.VARIANTS))
def test_each_ablation_variant_edits_the_committed_source(variant):
    """`scripts/loss_ablate.py` times the committed source with text edits:
    each must still match `csrc/loss.cu`, and a variant with edits must
    differ from it."""
    edits, _ = loss_ablate.VARIANTS[variant]
    text, _ = ablation.variant_sources("loss", loss_ablate.VARIANTS)[variant]
    assert (text != (_kernels.CSRC / "loss.cu").read_text()) == bool(edits)
