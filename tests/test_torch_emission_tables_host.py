"""The binning kernels' CUDA source (`gsplat_tpu_torch/csrc/binning.cu`) run
on the host: Bt' (`emission_tables`) against its plain twin
`_emission_tables_torch` bit for bit, and K1' (`expand_instances`,
`pack_instances`) from the same build on those tables against theirs.

The source is built with `g++ -O1 -ffp-contract=off` (no contraction, as
`-fmad=false` on the card) against the stub `cuda_runtime.h` of
`tests/test_torch_loss_kernel_host.py` (a block's threads as fibers on one
host thread, barriers and shuffles between them), extended as
`tests/test_torch_skeleton_kernel_host.py` extends it (warp votes,
`__ffs`), and here with 64-bit shuffles, `int4` and a `__nanosleep` that
yields to the other fibers. Every `__shared__` declaration becomes a
reference into the stub's shared memory, laid out in declaration order and
filled with NaN bytes before each block, so a value read before it was
written shows. The stub runs the blocks one after another, so each block
finds its predecessors' inclusive prefixes published; a host edit (which
must match the source once) lets a test withhold all but every k-th
block's, so that the look-back sums aggregates over more than one window
of 32 blocks.

On the host a float NaN cast to int32 is INT_MIN, in the source as in
torch's CPU twin (on the card both give 0), so a table row with a NaN run
carries a negative tile count here; the expand runs on the rows without
one. Inputs: a seeded screen from the JAX projection in both `tight_cull`
modes; N over several scan blocks and not a multiple of one (also with
withheld prefixes over 41 blocks); all rows dead; and
`synthetic.emission_edge_screen`, whose rows sit on the tables' edges (rect
heights 0, 8 and 9, det <= 0, a <= 0, cull_qmax <= 0, b = 0, centres on
tile edges, NaN and inf in mean2d and conic). `scripts/tables_ablate.py`'s
variants with two and one rows a thread are built too and must compute the
same tables, and each variant's text edits must match the source. The card
runs the same checks on the flagship frames and the edge screen
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
inline void __nanosleep(unsigned) { gs_wait(GS_RUN); }  // a spin yields

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

// the shared arrays' places in the stub's NaN-filled shared memory
constexpr size_t gs_align16(size_t x) { return (x + 15) / 16 * 16; }
inline char* gs_smem_at(size_t off) { return reinterpret_cast<char*>(gs_host_smem) + off; }

// the look-back's withheld prefixes: 0 publishes all, k only every k-th block's
inline int gs_withhold = 0;
inline bool gs_publish_prefix(int blk) { return gs_withhold == 0 || blk % gs_withhold == 0; }
extern "C" void gs_set_withhold(int k) { gs_withhold = k; }
"""

WITHHOLD = ("if (lane == 0) publish(flag, incl, blk, excl + block_sum, tag | SCAN_PREFIX);",
            "if (lane == 0 && gs_publish_prefix(blk)) "
            "publish(flag, incl, blk, excl + block_sum, tag | SCAN_PREFIX);")
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
    """binning.cu (or a variant's text) for g++."""
    assert src.count(WITHHOLD[0]) == 1
    src = host_shared(src.replace(*WITHHOLD))
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    assert launches == 3, launches
    assert "__shared__" not in src and "asm" not in src
    return src


# the committed source and `scripts/tables_ablate.py`'s variants that still
# compute the tables (fewer rows a thread: the scan of fewer warp sums)
HOST_VARIANTS = ("kernel", "rows2", "rows1")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("binning_host")
    (tmp / "cuda_runtime.h").write_text(STUB + f"#define GS_HOST_SMS {HOST_SMS}\n" + EXTRA
                                        + EXTRA64)
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
        lib.gs_set_withhold.argtypes = [ctypes.c_int]
        lib.gs_set_withhold.restype = None
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
    host_libs["kernel"].gs_set_withhold(0)


def rows(screen, keep):
    return ScreenGaussians(**{f: getattr(screen, f)[keep] for f in screen.__dataclass_fields__})


def check_tables(screen, tight, reps=2):
    """Bt' on the host against the twin, `reps` launches in a row (the
    scan state carries over; its ticket is 0 again after each)."""
    want = tb._emission_tables_torch(screen, 16, tight)
    for _ in range(reps):
        before = tb.emission_tables.launches
        got = tb.emission_tables(screen, 16, tight)
        assert tb.emission_tables.launches == before + (screen.rect_min.shape[0] > 0)
        for name, a, b in zip(("rect", "cum_excl", "trimmed", "t_lo", "cum_run"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert got[5] == want[5]
        scan = tb._table_scans.get(torch.device("cpu"))
        assert scan is None or int(scan[-1]) == 0, "the ticket is not back at 0"
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


@pytest.mark.parametrize("tight", [True, False])
def test_tables_on_the_host_equal_the_twin_on_a_seeded_screen(on_host, tight):
    _, ts, gx, gy = screen_pair(3, 1500, tight)  # 2 scan blocks, the last one part full
    tables = check_tables(ts, tight)
    assert tables[5] > 1000 and bool(tables[2].any()) == tight
    check_k1(ts, tables, tight, gx, gx * gy)


def test_tables_over_several_blocks(on_host):
    """N = 3 x 1024 + 77: four scan blocks, the last one part full."""
    screen, _ = emission_edge_screen(n=3 * tb.TABLE_TILE + 77, device="cpu", finite=True, seed=9)
    tables = check_tables(screen, True)
    assert bool((tables[0][:, 3] >= 0).all())
    check_k1(screen, tables, True)


def test_tables_with_withheld_prefixes(on_host):
    """41 scan blocks (N = 40 x 1024 + 77); with only every 37th block's
    prefix published, a look-back sums up to 36 aggregates, past one warp's
    window of 32."""
    screen, _ = emission_edge_screen(n=40 * tb.TABLE_TILE + 77, device="cpu", finite=True,
                                     seed=8)
    for k in (0, 37):
        on_host.gs_set_withhold(k)
        check_tables(screen, True)


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


@pytest.mark.parametrize("variant", ["rows2", "rows1"])
def test_fewer_rows_a_thread_on_the_host(on_host, host_libs, monkeypatch, variant):
    """`tables_ablate.py`'s variants with two and one rows a thread (scan
    blocks of 512 and 256: 16 and 8 warp sums) compute the same tables."""
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs[variant])
    tb._table_scan(torch.device("cpu"), -(-(3 * tb.TABLE_TILE + 77) // 256))
    screen, _ = emission_edge_screen(n=3 * tb.TABLE_TILE + 77, device="cpu", finite=True, seed=9)
    check_tables(screen, True)


@pytest.mark.parametrize("variant", sorted(tables_ablate.VARIANTS))
def test_each_tables_variant_edits_the_committed_source(variant):
    """`scripts/tables_ablate.py`: each variant's edits match
    `csrc/binning.cu`, and a variant with edits differs from it."""
    edits, _ = tables_ablate.VARIANTS[variant]
    text, _ = ablation.variant_sources("binning", tables_ablate.VARIANTS)[variant]
    assert (text != (_kernels.CSRC / "binning.cu").read_text()) == bool(edits)
