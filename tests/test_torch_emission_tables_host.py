"""The binning kernels' CUDA source (`gsplat_tpu_torch/csrc/binning.cu`) run
on the host: Bt' (`emission_tables`) against its plain twin
`_emission_tables_torch` bit for bit, K included, and K1'
(`expand_instances`, `pack_instances`) from the same build on those tables
against theirs.

The source is built with `g++ -O1 -ffp-contract=off` (no contraction, as
`-fmad=false` on the card) against the stub `cuda_runtime.h` of
`tests/test_torch_loss_kernel_host.py` (a block's threads as fibers on one
host thread, barriers and shuffles between them), extended as
`tests/test_torch_skeleton_kernel_host.py` extends it (warp votes,
`__ffs`), and here with 64-bit shuffles, `int2`, `int4` and a
`__nanosleep` that yields to the other fibers. Every `__shared__`
declaration becomes a reference into the stub's shared memory, laid out in
declaration order and filled with NaN bytes before each block, so a value
read before it was written shows.

Bt' is one cooperative launch of persistent blocks that meet at a grid
barrier, so the stub launches it cooperatively (`COOP`): every thread of
every block a fiber at once, each block with its own NaN-filled shared
memory, a block barrier per block; the stub card has three SMs and one
block an SM (`gs_set_occupancy`), at most 1,024 fibers in all, and refuses
a grid larger than that. A test can run the blocks last to first
(`gs_set_coop_reverse`), or hold one block back until every other waits
(`gs_set_coop_lag`), and before each launch the block sums in Bt''s state
are overwritten with garbage, so a block that reads them before the
barrier opens shows. A wait at the barrier that never ends aborts.

On the host a float NaN cast to int32 is INT_MIN, in the source as in
torch's CPU twin (on the card both give 0), so a table row with a NaN run
carries a negative tile count here; the expand runs on the rows without
one. Inputs: a seeded screen from the JAX projection in both `tight_cull`
modes; N under one block's chunk, not a multiple of a chunk, over several
rounds, and 0; all rows dead; and `synthetic.emission_edge_screen`, whose
rows sit on the tables' edges (rect heights 0, 8 and 9, det <= 0, a <= 0,
cull_qmax <= 0, b = 0, centres on tile edges, NaN and inf in mean2d and
conic). `scripts/tables_ablate.py`'s variants that compute the tables
(128-thread blocks, 1,024- and 256-row chunks) are built too and must
compute the same, and each variant's text edits must match the source. The card runs
the same checks on the flagship frames and the edge screen
(`chip_smoke.py`).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.ops import binning as jb
from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops.projection import ScreenGaussians
from gsplat_tpu_torch.ops.sort import sort_instances_torch, sort_key_bits
from gsplat_tpu_torch.scripts import ablation, tables_ablate
from gsplat_tpu_torch.synthetic import EMISSION_EDGE_KINDS, emission_edge_screen
from tests.test_torch_binning import screen_pair
from tests.test_torch_loss_kernel_host import STUB
from tests.test_torch_probe_ops_host import BF16
from tests.test_torch_skeleton_kernel_host import EXTRA, HOST_SMS, LAUNCH

GRID = (120, 68)  # the tile grid of a 1920 x 1080 frame
# the bf16 stub's NaN, made the one torch's CPU conversion gives (the
# twin's here; on the card both sides round with __float2bfloat16_rn)
BF16_NAN = "return {(unsigned short)((u >> 16) | 0x40)};"

EXTRA64 = r"""
#include <limits.h>
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline long long gs_spins = 0;  // yields in a wait; a cooperative launch aborts past a limit
inline bool gs_spun = false;    // the running fiber's last yield was a wait's
inline void __nanosleep(unsigned) { ++gs_spins; gs_spun = true; gs_wait(GS_RUN); }  // a spin yields

// 64-bit shuffles: a slot array behind one warp barrier, two in turns
inline unsigned long long gs_slot64[2][1024];
inline int gs_parity64[1024];
inline unsigned long long gs_lane64(unsigned long long v, int src_lane)
{
    const int t = gs_tid;
    unsigned long long* slot = gs_slot64[gs_parity64[t] ^= 1];
    slot[t] = v;
    __syncwarp();
    return slot[(t & ~31) | src_lane];
}
inline unsigned long long __shfl_up_sync(unsigned, unsigned long long v, int d)
{
    const int lane = gs_tid & 31;
    const unsigned long long u = gs_lane64(v, lane >= d ? lane - d : lane);
    return lane >= d ? u : v;
}
inline unsigned long long __shfl_xor_sync(unsigned, unsigned long long v, int m)
{
    return gs_lane64(v, (gs_tid & 31) ^ m);
}
inline unsigned long long __shfl_sync(unsigned, unsigned long long v, int src)
{
    return gs_lane64(v, src);
}

// the shared arrays' places in the stub's NaN-filled shared memory (in a
// cooperative launch, the running block's own)
constexpr size_t gs_align16(size_t x) { return (x + 15) / 16 * 16; }
inline char* gs_smem_base = nullptr;
inline char* gs_smem_at(size_t off)
{
    return (gs_smem_base ? gs_smem_base : reinterpret_cast<char*>(gs_host_smem)) + off;
}

// a look-back's withheld prefixes (St', `tests/test_torch_sort_kernel_host.py`):
// 0 publishes all, k only every k-th tile's
inline int gs_withhold = 0;
inline bool gs_publish_prefix(int blk) { return gs_withhold == 0 || blk % gs_withhold == 0; }
extern "C" void gs_set_withhold(int k) { gs_withhold = k; }
"""

# the stub card's blocks an SM, settable (the loss stub's query answers 0)
OCCUPANCY = ("inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor"
             "(int* n, const void*, int, size_t)\n{\n    *n = 0;",
             "inline int gs_occupancy = 1;\n"
             "inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor"
             "(int* n, const void*, int, size_t)\n{\n    *n = gs_occupancy;")

COOP = r"""
#include <tuple>
#include <type_traits>
#include <utility>
struct int2 { int x, y; };
inline unsigned atomicExch(unsigned* p, unsigned v) { unsigned o = *p; *p = v; return o; }
inline unsigned long long __ldcg(const unsigned long long* p) { return *p; }
extern "C" void gs_set_occupancy(int k) { gs_occupancy = k; }

// a cooperative launch: every thread of every block a fiber at once (the
// blocks last to first on request), each block its own NaN-filled shared
// memory; a warp barrier opens when its warp's live fibers wait there, a
// block barrier when its block's do
inline int gs_coop_reverse = 0, gs_coop_lag = -1;
extern "C" void gs_set_coop_reverse(int r) { gs_coop_reverse = r; }
// block `b` held back: its fibers run only in a pass where every other
// fiber that ran ended in a wait's yield (or none ran): the others reach
// the grid barrier first
extern "C" void gs_set_coop_lag(int b) { gs_coop_lag = b; }
inline std::vector<char> gs_coop_smem;

template <typename... P>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(P...), dim3 grid, dim3 block,
                                        void** args, size_t smem, cudaStream_t)
{
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, block.x, smem);
    const int blocks = (int)grid.x, threads = (int)(block.x * block.y * block.z);
    const int n = blocks * threads;
    if (blocks > GS_HOST_SMS * per_sm || n > 1024 || threads % 32 || smem || grid.y * grid.z != 1)
        return cudaErrorInvalidValue;  // not resident at once on the stub card
    auto vals = [&]<size_t... I>(std::index_sequence<I...>) {
        return std::tuple<std::decay_t<P>...>(*static_cast<std::decay_t<P>*>(args[I])...);
    }(std::index_sequence_for<P...>{});
    gridDim = grid;
    blockDim = block;
    gs_body = [&] { std::apply(kernel, vals); };
    const size_t per_block = sizeof gs_host_smem;
    gs_coop_smem.assign(blocks * per_block, (char)0xff);  // NaN
    static std::vector<char> stacks;
    const size_t stack = 64 * 1024;
    stacks.resize(n * stack);
    gs_fibers.assign(n, GsFiber{});
    for (int f = 0; f < n; ++f) {
        getcontext(&gs_fibers[f].ctx);
        gs_fibers[f].ctx.uc_stack.ss_sp = stacks.data() + f * stack;
        gs_fibers[f].ctx.uc_stack.ss_size = stack;
        gs_fibers[f].ctx.uc_link = &gs_sched;
        makecontext(&gs_fibers[f].ctx, gs_fiber_main, 0);
        gs_fibers[f].state = GS_RUN;
    }
    gs_spins = 0;
    for (;;) {
        bool moved = false, busy = false;
        for (int k = 0; k <= blocks; ++k) {
            const int b = k == blocks ? gs_coop_lag : gs_coop_reverse ? blocks - 1 - k : k;
            if (b < 0 || b >= blocks || (k < blocks && b == gs_coop_lag) || (k == blocks && busy))
                continue;
            for (int t = 0; t < threads; ++t) {
                const int f = b * threads + t;
                if (gs_fibers[f].state != GS_RUN) continue;
                gs_tid = f;
                blockIdx = {(unsigned)b, 0, 0};
                threadIdx = {(unsigned)t, 0, 0};
                gs_smem_base = gs_coop_smem.data() + b * per_block;
                gs_spun = false;
                swapcontext(&gs_sched, &gs_fibers[f].ctx);
                busy |= !gs_spun;
                moved = true;
            }
        }
        if (gs_spins > (1ll << 22)) std::abort();  // a barrier that never opens
        int live = 0;
        for (int w = 0; w * 32 < n; ++w) {
            int wl = 0, at = 0;
            for (int f = 32 * w; f < 32 * w + 32; ++f) {
                wl += gs_fibers[f].state != GS_DONE;
                at += gs_fibers[f].state == GS_WARP;
            }
            if (at && at == wl) {
                for (int f = 32 * w; f < 32 * w + 32; ++f) gs_fibers[f].state = GS_RUN;
                moved = true;
            }
        }
        for (int b = 0; b < blocks; ++b) {
            int bl = 0, at = 0;
            for (int f = b * threads; f < (b + 1) * threads; ++f) {
                bl += gs_fibers[f].state != GS_DONE;
                at += gs_fibers[f].state == GS_BLOCK;
            }
            live += bl;
            if (at && at == bl) {
                for (int f = b * threads; f < (b + 1) * threads; ++f)
                    if (gs_fibers[f].state == GS_BLOCK) gs_fibers[f].state = GS_RUN;
                moved = true;
            }
        }
        if (!live) break;
        if (!moved) std::abort();
    }
    gs_smem_base = nullptr;
    return cudaSuccess;
}
"""
SHARED = re.compile(r"__shared__\s+(?:__align__\(\d+\)\s+)?(?P<type>.+?)\s+"
                    r"(?P<decls>\w+(?:\[[^\]]+\])?(?:\s*,\s*\w+(?:\[[^\]]+\])?)*)\s*;")
DECL = re.compile(r"(\w+)(?:\[([^\]]+)\])?")


def host_shared(src: str) -> str:
    """Each `__shared__` declaration a reference into the stub's shared
    memory, 16-byte aligned, in declaration order from 0 in each kernel."""
    out = []
    for part in re.split(r"(?=__global__)", src):
        prev = None

        def one(m):
            nonlocal prev
            lines = []
            for name, size in DECL.findall(m.group("decls")):
                t = m.group("type")
                full = f"{t}[{size}]" if size else t
                off = f"gs_align16(gs_off_{prev[0]} + sizeof({prev[1]}))" if prev else "0"
                ref = f"{t} (&{name})[{size}]" if size else f"{t}& {name}"
                ptr = f"{t} (*)[{size}]" if size else f"{t}*"
                lines.append(f"constexpr size_t gs_off_{name} = {off}; "
                             f"{ref} = *reinterpret_cast<{ptr}>(gs_smem_at(gs_off_{name}));")
                prev = (name, full)
            return " ".join(lines)

        out.append(SHARED.sub(one, part))
    return "".join(out)


def host_source(src: str) -> str:
    """binning.cu (or a variant's text) for g++: the shared arrays in the
    stub's memory, each `<<<...>>>` launch a call of the stub's launcher
    (K1''s expand and pack); Bt''s cooperative launch goes to `COOP`'s."""
    src = host_shared(src)
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    assert launches == 2, launches
    assert src.count("cudaLaunchCooperativeKernel(") == 1
    assert "__shared__" not in src and "asm" not in src
    return src


# the committed source and `scripts/tables_ablate.py`'s variants that
# compute the tables
HOST_VARIANTS = ("kernel", "threads_128", "chunk_1024", "chunk_256")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("binning_host")
    assert STUB.count(OCCUPANCY[0]) == 1
    (tmp / "cuda_runtime.h").write_text(STUB.replace(*OCCUPANCY)
                                        + f"#define GS_HOST_SMS {HOST_SMS}\n" + EXTRA
                                        + EXTRA64 + COOP)
    nan = int(torch.tensor([float("nan")]).to(torch.bfloat16).view(torch.int16)) & 0xFFFF
    assert BF16.count(BF16_NAN) == 1
    (tmp / "cuda_bf16.h").write_text(BF16.replace(BF16_NAN, f"return {{(unsigned short){nan}}};"))
    (tmp / "common.cuh").write_text((_kernels.CSRC / "common.cuh").read_text())
    sources = ablation.variant_sources("binning", tables_ablate.VARIANTS)
    jobs = {}
    for name in HOST_VARIANTS:
        (tmp / f"{name}.cpp").write_text(host_source(sources[name][0]))
        out = tmp / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [gxx, "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-std=c++20", "-shared",
             "-fPIC", "-pthread", "-w", "-I", str(tmp), "-o", str(out), str(tmp / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
        lib = _kernels.open_library(out, "binning")
        for fn in ("gs_set_occupancy", "gs_set_coop_reverse", "gs_set_coop_lag"):
            getattr(lib, fn).argtypes = [ctypes.c_int]
            getattr(lib, fn).restype = None
        libs[name] = lib
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs["kernel"])
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # the wrappers' launch counters as they were after the test: other
    # tests in this process read them
    for w in (tb.emission_tables, tb.expand_instances, tb.pack_instances):
        for c in [c for c in vars(w) if c.startswith("launches")]:
            monkeypatch.setattr(w, c, getattr(w, c))
    yield host_libs["kernel"]
    for lib in host_libs.values():
        lib.gs_set_coop_reverse(0)
        lib.gs_set_coop_lag(-1)


def rows(screen, keep):
    return ScreenGaussians(**{f: getattr(screen, f)[keep] for f in screen.__dataclass_fields__})


GARBAGE = 0x5A5A5A5A5A5A5A5A  # written over the block sums before each launch


def check_tables(screen, tight, reps=2):
    """Bt' on the host against the twin, `reps` launches in a row (the
    state carries over), its block sums overwritten with garbage before
    each; after each the barrier's count of arrivals is 0 again and its
    last number the launch's last."""
    want = tb._emission_tables_torch(screen, 16, tight)
    n = screen.rect_min.shape[0]
    cpu = torch.device("cpu")
    for _ in range(reps):
        entry = tb._table_states.get(cpu)
        if entry is not None:
            entry[0][tb._TABLE_HEAD:] = GARBAGE
        before = tb.emission_tables.launches
        got = tb.emission_tables(screen, 16, tight)
        assert tb.emission_tables.launches == before + (n > 0)
        for name, a, b in zip(("rect", "cum_excl", "trimmed", "t_lo", "cum_run"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert got[5] == want[5]
        if n:
            state, number = tb._table_states[cpu]
            assert int(state[0]) == 0, "the barrier's count of arrivals is not back at 0"
            assert int(state[1]) == number - 1, "the last barrier's number"
    return got


def check_k1(screen, tables, tight, gx=GRID[0], num_tiles=GRID[0] * GRID[1]):
    """K1''s expand and pack from the same build on Bt''s tables, against
    their twins: keys, gids and the live packet rows; every packet mode."""
    rect, _, _, _, _, total = tables
    args = (*tables[:5], screen, total, gx, tight)
    keys, gid, packets = tb.expand_instances(*args)
    wkeys, wgid, wpackets = tb._expand_instances_torch(*args)
    live = rect[:, 3] > 0
    assert torch.equal(keys, wkeys) and torch.equal(gid, wgid)
    assert torch.equal(packets[live].view(torch.int32), wpackets[live].view(torch.int32))
    keys_sorted, gauss_sorted = sort_instances_torch(keys, gid, sort_key_bits(num_tiles))
    for mode in tb.PACKET_MODES:
        got = tb.pack_instances(keys_sorted, gauss_sorted, packets, num_tiles, mode)
        want = tb._pack_instances_torch(keys_sorted, gauss_sorted, wpackets, num_tiles, mode)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), mode
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b), mode
    return total


def edge_rows(n, seed):
    return emission_edge_screen(n=n, device="cpu", finite=True, seed=seed)[0]


@pytest.mark.parametrize("tight", [True, False])
def test_tables_on_the_host_equal_the_twin_on_a_seeded_screen(on_host, tight):
    _, ts, gx, gy = screen_pair(3, 1500, tight)  # 3 blocks of 512 rows, the last one part full
    assert tb.table_layout(1500)[:3] == (3, 512, 1)
    tables = check_tables(ts, tight)
    assert tables[5] > 1000 and bool(tables[2].any()) == tight
    check_k1(ts, tables, tight, gx, gx * gy)


def test_tables_over_several_blocks(on_host):
    """N = 3 x 1024 + 77: three blocks of 1,056 rows, the last one part
    full, and the expand on their tables."""
    n = 3 * 1024 + 77
    assert tb.table_layout(n)[:3] == (3, 1056, 1)
    screen = edge_rows(n, 9)
    tables = check_tables(screen, True)
    assert bool((tables[0][:, 3] >= 0).all())
    check_k1(screen, tables, True)


@pytest.mark.parametrize("n,layout", [(20, (1, 32, 1)), (100, (3, 64, 1)), (4 * 8192 + 77, (3, 8192, 2))])
def test_tables_at_the_chunks_edges(on_host, n, layout):
    """N under one block's chunk (one block, a partial warp); N that leaves
    the last block part full and one block empty; N over one round of three
    8,192-row chunks (a second round, a barrier each)."""
    assert tb.table_layout(n)[:3] == layout
    screen = edge_rows(n, 9)
    tables = check_tables(screen, True)
    assert bool((tables[0][:, 3] >= 0).all())
    if n < 1000:
        check_k1(screen, tables, True)


@pytest.mark.parametrize("order", ["last_to_first", "block_0_held_back"])
def test_tables_in_another_block_order(on_host, order):
    """The fibers run the blocks last to first; or block 0 (whose sum every
    other block adds) runs only while the others wait, so they reach the
    grid barrier first and must wait there for it."""
    screen = edge_rows(2 * 1024 + 600, 8)
    if order == "last_to_first":
        on_host.gs_set_coop_reverse(1)
    else:
        on_host.gs_set_coop_lag(0)
    check_tables(screen, True)
    check_tables(screen, False)


def test_tables_of_no_rows(on_host):
    screen = rows(edge_rows(50, 3), torch.zeros(50, dtype=torch.bool))
    for tight in (True, False):
        got = tb.emission_tables(screen, 16, tight)
        assert got[5] == 0 and all(t.shape[0] == 0 for t in got[:5])
        assert int(tb.emission_tables(screen, 16, tight, read_total=False)[5]) == 0


def test_tables_with_every_row_dead(on_host):
    screen, _ = emission_edge_screen(n=700, device="cpu", finite=True, seed=2)
    dead = ScreenGaussians(**{**{f: getattr(screen, f) for f in screen.__dataclass_fields__},
                              "tiles_touched": torch.zeros_like(screen.tiles_touched)})
    for tight in (True, False):
        tables = check_tables(dead, tight)
        assert tables[5] == 0 and not bool(tables[1].any()) and not bool(tables[2].any())
        check_k1(dead, tables, tight)


@pytest.mark.parametrize("tight", [True, False])
def test_tables_on_edge_rows(on_host, tight):
    """Every kind of `EMISSION_EDGE_KINDS`; the expand on the rows whose run
    holds no NaN (a negative tile count on the host)."""
    screen, kind = emission_edge_screen(device="cpu")
    tables = check_tables(screen, tight)
    counts = tables[0][:, 3]
    assert set(kind) == set(EMISSION_EDGE_KINDS)
    assert not bool(counts[torch.from_numpy(kind == "dead")].any())
    keep = counts >= 0
    assert bool((~keep).any()) == tight  # NaN in a trimmed row's run: INT_MIN here
    sub = rows(screen, keep)
    check_k1(sub, check_tables(sub, tight, reps=1), tight)


def test_cum_excl_and_total_equal_the_jax_prefix_sum(on_host):
    """The kernel's (and the twin's) cum_excl and K against the JAX
    package's `cum - tiles_post` and `cum[-1]` (`gsplat_tpu/ops/binning.py:
    673-675`), and K against its `pack_bins`' instance count."""
    js, ts, gx, gy = screen_pair(3, 1500, True)
    _, _, _, tiles_post = jax.jit(lambda s: jb.compute_row_runs(s, 16, True))(js)
    cum = jnp.cumsum(tiles_post)
    got = tb.emission_tables(ts, 16, True)
    want = tb._emission_tables_torch(ts, 16, True)
    for tables in (got, want):
        np.testing.assert_array_equal(tables[1].numpy(), np.asarray(cum - tiles_post))
        assert tables[5] == int(cum[-1])
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, 1 << 15, 16, tight_cull=True))(js)
    assert int(jp.overflow) == 0 and int(jp.num_instances) == got[5]


def test_tables_of_columns_off_a_16_byte_boundary(on_host):
    """The kernel reads the int2 and float2 columns as 8-byte loads: the
    wrapper copies a contiguous column 4 bytes off a 16-byte boundary (off
    8 bytes too), such as a one-row slice of the mesh's gathered columns,
    and the tables are the twin's."""
    screen = edge_rows(100, 5)
    for name in ("rect_min", "rect_max", "conic", "mean2d", "cull_qmax", "tiles_touched"):
        col = getattr(screen, name)
        off = torch.cat([col.new_zeros(1), col.reshape(-1)])[1:].view(col.shape)
        assert off.data_ptr() % 16 == 4 and off.is_contiguous()
        moved = ScreenGaussians(**{**{f: getattr(screen, f) for f in screen.__dataclass_fields__},
                                   name: off})
        check_tables(moved, True, reps=1)


def test_emission_tables_refuses_cpu_tensors(monkeypatch):
    screen, _ = emission_edge_screen(n=300, device="cpu", finite=True)
    monkeypatch.setattr(tb.emission_tables, "launches", 0)
    with pytest.raises(ValueError, match="CUDA"):
        tb.emission_tables(screen, 16, True)
    assert tb.emission_tables.launches == 0
    # the dispatch takes the twin on the CPU, and pack_bins_torch its tables
    tables = tb._emission_tables(screen, 16, True)
    want = tb._emission_tables_torch(screen, 16, True)
    assert all(torch.equal(a, b) for a, b in zip(tables[:5], want[:5])) and tables[5] == want[5]
    assert tb.emission_tables.launches == 0


@pytest.mark.parametrize("variant", ["threads_128", "chunk_1024", "chunk_256"])
def test_tables_variants_on_the_host(on_host, host_libs, monkeypatch, variant):
    """`tables_ablate.py`'s variants that compute the tables: blocks of 128
    threads (four warps' sums a step), and chunks of at most 1,024 or 256
    rows (here three or nine rounds, a barrier each)."""
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs[variant])
    n = 2 * 3 * 1024 + 300
    want = {"threads_128": (3, 2176, 1), "chunk_1024": (3, 1024, 3),
            "chunk_256": (3, 256, 9)}[variant]
    assert tb.table_layout(n)[:3] == want
    host_libs[variant].gs_set_coop_reverse(1)
    check_tables(edge_rows(n, 9), True)
    check_tables(edge_rows(n, 4), False, reps=1)


def test_a_grid_too_large_to_be_resident_is_refused(on_host, host_libs, monkeypatch):
    """The cooperative launch refuses a grid the card cannot hold at once
    (here the layout's, with the stub's blocks an SM lowered after the
    layout was cached), and the wrapper raises: no block waits forever."""
    lib = host_libs["chunk_1024"]
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    n = 3 * 1024 + 5
    assert tb.table_layout(n)[0] == 3
    lib.gs_set_occupancy(0)
    try:
        with pytest.raises(RuntimeError, match="emission_tables"):
            tb.emission_tables(edge_rows(n, 1), 16, True)
    finally:
        lib.gs_set_occupancy(1)


@pytest.mark.parametrize("variant", sorted(tables_ablate.VARIANTS))
def test_each_tables_variant_edits_the_committed_source(variant):
    """`scripts/tables_ablate.py`: each variant's edits match
    `csrc/binning.cu`, and a variant with edits differs from it."""
    edits, _ = tables_ablate.VARIANTS[variant]
    text, _ = ablation.variant_sources("binning", tables_ablate.VARIANTS)[variant]
    assert (text != (_kernels.CSRC / "binning.cu").read_text()) == bool(edits)
