"""The skeleton probes' CUDA source (`gsplat_tpu_torch/csrc/probe_skeleton.cu`)
and K2''s (`csrc/rasterize_fwd.cu`) run on the host, through the wrappers
`probes.ablate.skel_fwd`, `skel_bwd` and `ops.rasterize_cuda.blend_fwd`,
against their plain twins bit for bit.

The sources are built with `g++ -O1 -ffp-contract=off` against the stub
`cuda_runtime.h` of `tests/test_torch_loss_kernel_host.py` (a block's
threads as fibers on one host thread, barriers and shuffles between them),
extended here with: every `__shared__` array in the stub's shared memory,
which is filled with NaN before each block, so a value read before it was
written shows; the mbarriers, each an arrival count, a byte count and a
phase bit, a waiting thread yielding to the others; the bulk copy, queued
and landed (a `memcpy` that completes its bytes on its mbarrier) only when
some thread waits, one copy per failed try, so a thread that reads a stage
before its phase completes reads NaN; the warp votes and
`__syncthreads_count`; and `expf` as torch's own CPU `exp`, learnt value
by value over reruns (the host's libm rounds about 1% of them otherwise).
Every replacement must match the source once, so an edited kernel fails
here first.

What this holds: P1' (bulk copies through a ring of mbarrier stages, in
persistent blocks: the stub's SM count makes three) and the unchanged P2'
equal `skel_fwd_torch` / `skel_bwd_torch`, and K2' equals
`blend_packed_torch`, on a seeded frame and on edge ranges: an empty tile,
a single instance, ranges that start mid-chunk and off 16 bytes, a table of
K % 4 != 0 columns, ranges longer than the ring and ranges that end at the
table's end, for a (16, K) and a (10, K) table, where the last row's last
floats are past the table's last whole 16-byte group. And P1''s bulk copies
cover all ten rows of every instance of every range (but those last
floats, which it loads), read nothing outside the table, and all land.
The card runs the same checks on the flagship frame and an edge table
(`chip_smoke.py`'s `probe_skeleton` phase).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from gsplat_tpu_torch.probes import ablate
from gsplat_tpu_torch.scripts import ablation, skeleton_ablate
from tests.test_torch_loss_kernel_host import STUB
from tests.test_torch_probe_ops_host import BF16

HOST_SMS = 3  # the stub card's SMs: P1''s persistent grid is 3 blocks

EXTRA = r"""
#include <algorithm>
#include <deque>
#include <unordered_map>
using std::isfinite;
using std::isinf;
using std::max;
using std::min;
#define __align__(n) alignas(n)
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int)
{
    *v = GS_HOST_SMS;
    return cudaSuccess;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline void __trap() { std::abort(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

// the warp votes: a slot array behind one warp barrier
inline unsigned __ballot_sync(unsigned, int p)
{
    const int t = gs_tid;
    float* slot = gs_slot[gs_parity[t] ^= 1];
    slot[t] = p ? 1.0f : 0.0f;
    __syncwarp();
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        if (slot[(t & ~31) + l] != 0.0f) m |= 1u << l;
    return m;
}
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == 0xffffffffu; }
// the last call's reads are done before the word is cleared, and it is
// cleared before any thread counts
inline int gs_count_word;
inline int __syncthreads_count(int p)
{
    __syncthreads();
    if (gs_tid == 0) gs_count_word = 0;
    __syncthreads();
    if (p) ++gs_count_word;
    __syncthreads();
    return gs_count_word;
}

// expf as the test taught it (torch's CPU exp), else the host's, noted
inline std::unordered_map<unsigned, float> gs_exp_known;
inline std::vector<float> gs_exp_unknown;
inline float gs_expf(float x)
{
    unsigned u;
    std::memcpy(&u, &x, 4);
    const auto it = gs_exp_known.find(u);
    if (it != gs_exp_known.end()) return it->second;
    gs_exp_unknown.push_back(x);
    return std::exp(x);
}
#define expf gs_expf
extern "C" long long gs_exp_unknown_count() { return (long long)gs_exp_unknown.size(); }
extern "C" void gs_exp_learn(const float* y)
{
    for (size_t i = 0; i < gs_exp_unknown.size(); ++i) {
        unsigned u;
        std::memcpy(&u, &gs_exp_unknown[i], 4);
        gs_exp_known[u] = y[i];
    }
    gs_exp_unknown.clear();
}
extern "C" void gs_exp_unknown_read(float* x)
{
    std::copy(gs_exp_unknown.begin(), gs_exp_unknown.end(), x);
}

// mbarriers: pending arrivals, the count they restart at, bytes still due
// and the phase bit; a phase completes when no arrival and no byte is due
struct GsBar { unsigned pending, expected; long long tx; unsigned phase; };
inline std::unordered_map<const void*, GsBar> gs_bars;
inline void gs_bar_settle(GsBar& b)
{
    if (b.pending == 0 && b.tx == 0) {
        b.phase ^= 1u;
        b.pending = b.expected;
    }
}
inline void gs_mbar_init(unsigned long long* bar, unsigned count)
{
    gs_bars[bar] = GsBar{count, count, 0, 0};
}
inline void gs_mbar_arrive(unsigned long long* bar)
{
    GsBar& b = gs_bars.at(bar);
    if (b.pending == 0) std::abort();
    --b.pending;
    gs_bar_settle(b);
}
inline void gs_mbar_expect_tx(unsigned long long* bar, unsigned bytes)
{
    gs_bars.at(bar).tx += bytes;
}

// bulk copies: queued when issued, landed one per failed wait
struct GsCopy { void* dst; const void* src; unsigned bytes; unsigned long long* bar; };
inline std::deque<GsCopy> gs_copies;
inline std::vector<long long> gs_copy_log;  // source address and bytes of each copy
inline void gs_bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar)
{
    if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16 || bytes == 0) std::abort();
    gs_copies.push_back(GsCopy{dst, src, bytes, bar});
    gs_copy_log.push_back((long long)(uintptr_t)src);
    gs_copy_log.push_back((long long)bytes);
}
inline bool gs_land_one()
{
    if (gs_copies.empty()) return false;
    const GsCopy c = gs_copies.front();
    gs_copies.pop_front();
    std::memcpy(c.dst, c.src, c.bytes);
    GsBar& b = gs_bars.at(c.bar);
    b.tx -= c.bytes;
    gs_bar_settle(b);
    return true;
}
inline unsigned gs_mbar_test(unsigned long long* bar, unsigned parity)
{
    if (gs_bars.at(bar).phase != parity) return 1;
    gs_land_one();
    gs_wait(GS_RUN);  // yield to the other fibers
    return 0;
}
extern "C" long long gs_copy_log_size() { return (long long)gs_copy_log.size(); }
extern "C" void gs_copy_log_read(long long* out)
{
    std::copy(gs_copy_log.begin(), gs_copy_log.end(), out);
    gs_copy_log.clear();
}
extern "C" long long gs_copies_pending() { return (long long)gs_copies.size(); }
"""

MBAR_WAIT = ('        asm volatile("{\\n\\t.reg .pred p;\\n\\t"\n'
             '                     "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\\n\\t"\n'
             '                     "selp.u32 %0, 1, 0, p;\\n\\t}"\n'
             '                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");')
# the kernels' PTX, shared memory and card-only constants, each replaced once
HOST_EDITS = {
    "probe_skeleton": (
        ("    extern __shared__ __align__(16) unsigned char fwd_smem[];",
         "    unsigned char* fwd_smem = reinterpret_cast<unsigned char*>(gs_host_smem);"),
        ("    __shared__ float batch[N_ATTR][BWD_BATCH];",
         "    float (&batch)[N_ATTR][BWD_BATCH] =\n"
         "        *reinterpret_cast<float (*)[N_ATTR][BWD_BATCH]>(gs_host_smem);"),
        ('asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");',
         "gs_mbar_init(bar, count);"),
        ('asm volatile("{\\n\\t.reg .b64 st;\\n\\tmbarrier.arrive.shared.b64 st, [%0];\\n\\t}"\n'
         '                 ::"r"(smem_addr(bar)) : "memory");', "gs_mbar_arrive(bar);"),
        ('asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"\n'
         '                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");',
         "gs_mbar_expect_tx(bar, bytes);"),
        (MBAR_WAIT, "        done = gs_mbar_test(bar, parity);"),
        ('asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
         '                 " [%0], [%1], %2, [%3];"\n'
         '                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");',
         "gs_bulk_copy(dst, src, bytes, bar);"),
        ('asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");', ""),
        ('asm volatile("fence.proxy.async.shared::cta;" ::: "memory");', ""),
        ("constexpr unsigned MBAR_PATIENCE = 1u << 24;", "constexpr unsigned MBAR_PATIENCE = 1u << 16;"),
    ),
    "rasterize_fwd": (
        ("    __shared__ float4 batch[3][PPT];",
         "    float4 (&batch)[3][PPT] = *reinterpret_cast<float4 (*)[3][PPT]>(gs_host_smem);"),
        ("    __shared__ float box[5][PPT];  // x0, x1, y0, y1, tau_m",
         "    float (&box)[5][PPT] = *reinterpret_cast<float (*)[5][PPT]>(gs_host_smem + 12 * PPT);"),
    ),
}
LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>\(([^;]*)\);")
STUB_FNS = {"gs_exp_unknown_count": ([], ctypes.c_longlong),
            "gs_exp_learn": ([ctypes.c_void_p], None),
            "gs_exp_unknown_read": ([ctypes.c_void_p], None),
            "gs_copy_log_size": ([], ctypes.c_longlong),
            "gs_copy_log_read": ([ctypes.c_void_p], None),
            "gs_copies_pending": ([], ctypes.c_longlong)}


def host_source(name: str) -> str:
    """csrc/<name>.cu for g++: the PTX and the shared arrays replaced, each
    launch a call of the stub's launcher."""
    src = (_kernels.CSRC / f"{name}.cu").read_text()
    for old, new in HOST_EDITS[name]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    assert launches >= 1
    assert "asm" not in src.replace("gs_mbar", ""), "a PTX statement without a host form"
    assert "__shared__" not in src, "a shared array outside the stub's NaN-filled memory"
    return src


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("skeleton_host")
    (tmp / "cuda_runtime.h").write_text(STUB + f"#define GS_HOST_SMS {HOST_SMS}\n" + EXTRA)
    (tmp / "cuda_bf16.h").write_text(BF16)
    (tmp / "common.cuh").write_text((_kernels.CSRC / "common.cuh").read_text())
    jobs = {}
    for name in HOST_EDITS:
        (tmp / f"{name}_host.cpp").write_text(host_source(name))
        out = tmp / f"lib{name}_host.so"
        jobs[name] = (subprocess.Popen(
            [gxx, "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++20", "-shared",
             "-fPIC", "-pthread", "-w", "-I", str(tmp), "-o", str(out), str(tmp / f"{name}_host.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
        lib = _kernels.open_library(out, name)
        for fn, (argtypes, restype) in STUB_FNS.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs[name])
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    return host_libs


def bits(t):
    return t.contiguous().view(torch.int32)


def copy_log(lib):
    buf = np.zeros(int(lib.gs_copy_log_size()), np.int64)
    lib.gs_copy_log_read(buf.ctypes.data)
    return buf.reshape(-1, 2)


def seeded_frame():
    """A small seeded scene projected and binned on the CPU: (inst_t,
    tile_start, tile_end, grid_x, grid_y)."""
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims
    from gsplat_tpu_torch.synthetic import tiny_scene

    params, alive, camera = tiny_scene(n=1500, width=64, height=48, device="cpu")
    gx, gy = grid_dims(camera, 16)
    with torch.no_grad():
        screen = preprocess(params, alive, camera, make_render_settings(sh_degree=3), gx, gy)
        pb = pack_bins(screen, gx, gy)
    return pb.inst_t, pb.tile_start, pb.tile_end, gx, gy


@pytest.fixture(scope="module")
def frame():
    return seeded_frame()


def check_coverage(log, inst_t, starts, ends):
    """Every copy reads whole 16-byte groups inside the table; together
    they cover rows 0-9 of every range, but the floats past the table's
    last whole group."""
    rows, k = inst_t.shape
    whole = rows * k // 4 * 4
    assert len(log), "no bulk copy"
    off = (log[:, 0] - inst_t.data_ptr()) // 4
    assert ((log[:, 0] - inst_t.data_ptr()) % 16 == 0).all() and (log[:, 1] % 16 == 0).all()
    assert (off >= 0).all() and (off + log[:, 1] // 4 <= whole).all(), "a copy outside the table"
    covered = np.zeros(rows * k + 1, np.int64)
    np.add.at(covered, off, 1)
    np.add.at(covered, off + log[:, 1] // 4, -1)
    covered = np.cumsum(covered)[:-1] > 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        for r in range(10):
            cols = np.arange(r * k + s, r * k + e)
            assert covered[cols[cols < whole]].all(), (s, e, r)


@pytest.mark.parametrize("rows,k", skeleton_ablate.EDGE_TABLES)
def test_skel_fwd_on_the_host_equals_its_twin_on_edge_ranges(on_host, rows, k):
    inst_t = skeleton_ablate.edge_table(rows, k)
    starts, ends, gx, gy = skeleton_ablate.edge_ranges(k)
    lib = on_host["probe_skeleton"]
    copy_log(lib)
    got = ablate.skel_fwd(inst_t, starts, ends, gx, gy)
    assert torch.equal(bits(got), bits(ablate.skel_fwd_torch(inst_t, starts, ends, gx, gy)))
    assert int(lib.gs_copies_pending()) == 0
    check_coverage(copy_log(lib), inst_t, starts, ends)


def test_skel_fwd_and_bwd_on_the_host_equal_their_twins_on_a_frame(on_host, frame):
    inst_t, starts, ends, gx, gy = frame
    assert gx * gy > HOST_SMS  # each persistent block walks several tiles
    lib = on_host["probe_skeleton"]
    copy_log(lib)
    got = ablate.skel_fwd(inst_t, starts, ends, gx, gy)
    assert torch.equal(bits(got), bits(ablate.skel_fwd_torch(inst_t, starts, ends, gx, gy)))
    check_coverage(copy_log(lib), inst_t, starts, ends)
    fwd = torch.zeros((gx * gy, 256, 8))
    dout = torch.ones((gx * gy, 256, 8))
    gotb = ablate.skel_bwd(inst_t, starts, ends, gx, gy, fwd, dout)
    assert torch.equal(bits(gotb), bits(ablate.skel_bwd_torch(inst_t, starts, ends, gx, gy, fwd, dout)))


def blend_on_host(lib, *args, **kw):
    """K2' with its `expf` taught torch's, rerun until it asks for no value
    it was not taught."""
    for _ in range(8):
        out = rc.blend_fwd(*args, **kw)
        n = int(lib.gs_exp_unknown_count())
        if n == 0:
            return out
        x = np.zeros(n, np.float32)
        lib.gs_exp_unknown_read(x.ctypes.data)
        y = torch.exp(torch.from_numpy(x)).numpy()
        lib.gs_exp_learn(y.ctypes.data)
    raise AssertionError("K2' kept asking for new exp values")


@pytest.mark.parametrize("ranges", ["frame", "saturated", "edges"])
def test_blend_fwd_on_the_host_equals_its_twin(on_host, frame, ranges):
    """On the frame; on the edge ranges over the frame's rows; and on those
    with opacity 0.9 and footprints ~1.8x as wide, where most pixels stop
    early, so warps and whole blocks leave their walks before its end."""
    inst_t, starts, ends, gx, gy = frame
    if ranges != "frame":
        k = 3203  # K % 4 == 3, the frame's rows repeated
        inst_t = inst_t[:, torch.arange(k) % inst_t.shape[1]].contiguous()
        starts, ends, gx, gy = skeleton_ablate.edge_ranges(k)
    if ranges == "saturated":
        inst_t[5] = 0.9
        inst_t[2:5] *= 0.3
    lib = on_host["rasterize_fwd"]
    for track in (False, True):
        got = blend_on_host(lib, inst_t, starts, ends, gx, gy, track_contrib=track)
        want = rc.blend_packed_torch(inst_t, starts, ends, gx, gy, track_contrib=track)
        assert torch.equal(bits(got), bits(want)), track


@pytest.mark.parametrize("variant", sorted(skeleton_ablate.LIBRARIES))
def test_each_skeleton_variant_edits_the_committed_source(variant):
    """`scripts/skeleton_ablate.py`: each variant's edits match
    `csrc/probe_skeleton.cu` and change it; `kernel` is the source as it is."""
    text, _ = ablation.variant_sources("probe_skeleton", skeleton_ablate.LIBRARIES)[variant]
    assert (text != (_kernels.CSRC / "probe_skeleton.cu").read_text()) == (variant != "kernel")


@pytest.mark.parametrize("variant", sorted(skeleton_ablate.K2_LIBRARIES))
def test_the_k2_skeleton_edits_the_committed_source(variant):
    text, _ = ablation.variant_sources("rasterize_fwd", skeleton_ablate.K2_LIBRARIES)[variant]
    assert (text != (_kernels.CSRC / "rasterize_fwd.cu").read_text()) == (variant != "k2")
