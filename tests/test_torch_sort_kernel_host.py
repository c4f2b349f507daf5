"""The instance sort's CUDA source (`gsplat_tpu_torch/csrc/sort.cu`, kernel
St') run on the host, through the wrapper `sort_instances`, against its
plain twin `sort_instances_torch` bit for bit.

The source is built with `g++ -O1` against the stub `cuda_runtime.h` of
`tests/test_torch_loss_kernel_host.py` (a block's threads as fibers on one
host thread, barriers and shuffles between them, the blocks one after
another), extended as `tests/test_torch_emission_tables_host.py` extends
it (warp votes, 64-bit shuffles, a `__nanosleep` that yields), and here
with 32-bit shuffles, `__match_any_sync`, `__popc`, `__ldcg` and the
asynchronous copies (queued, landed when their thread waits). The
dynamic shared memory is the stub's, filled with NaN bytes before each
block, so a value read before it was written shows. The stub has three
SMs, so the histogram runs in up to six blocks and its last block writes
the offsets. A host edit (which must match the source once) lets a test
withhold all but every k-th tile's inclusive counts, so that the look-back
sums counts over many tiles.

Cases: seeded keys with many duplicates, all keys equal (stability), one
tile, 46-bit keys (3840x2160's 32,400 tiles), K = 1 and K not a multiple of
a tile, K over 40 tiles (of 1,024 keys) with withheld inclusive counts, and the real keys
of K1''s expand on the JAX projection's seeded screen in both `tight_cull`
modes; the 11-bit-digit variant of `scripts/sort_ablate.py` on some of
them. The sort runs twice on each case, so its counters must be 0 again
after each launch. And the expand's keys meet St''s precondition (bit 31
clear, the live bits under 2^key_bits) on that screen and on
`synthetic.emission_edge_screen`. The card runs the same checks on the
flagship frames and adversarial keys (`chip_smoke.py`).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import sort as so
from gsplat_tpu_torch.scripts import ablation, sort_ablate
from gsplat_tpu_torch.synthetic import emission_edge_screen
from tests.test_torch_binning import screen_pair
from tests.test_torch_emission_tables_host import EXTRA64, rows
from tests.test_torch_loss_kernel_host import STUB
from tests.test_torch_skeleton_kernel_host import EXTRA, HOST_SMS, LAUNCH

EXTRA32 = r"""
// 32-bit shuffles and the digit match: a slot array behind one warp barrier
inline unsigned gs_slot32[2][1024];
inline int gs_parity32[1024];
inline unsigned* gs_lanes32(unsigned v)
{
    const int t = gs_tid;
    unsigned* slot = gs_slot32[gs_parity32[t] ^= 1];
    slot[t] = v;
    __syncwarp();
    return slot + (t & ~31);
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, int d)
{
    const int lane = gs_tid & 31;
    const unsigned u = gs_lanes32(v)[lane >= d ? lane - d : lane];
    return lane >= d ? u : v;
}
inline unsigned __match_any_sync(unsigned, unsigned v)
{
    const unsigned* w = gs_lanes32(v);
    unsigned m = 0;
    for (int l = 0; l < 32; ++l)
        if (w[l] == v) m |= 1u << l;
    return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __ldcg(const unsigned* p) { return *p; }
struct longlong2 { long long x, y; };
"""

# the asynchronous copies: queued per thread, landed when that thread waits,
# so a value read before its wait is the NaN fill
PIPELINE = r"""
#pragma once
#include <cuda_runtime.h>
struct GsAsync { void* dst; const void* src; size_t n; };
inline std::vector<GsAsync> gs_async[1024];
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n)
{
    gs_async[gs_tid].push_back(GsAsync{dst, src, n});
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t)
{
    for (const GsAsync& c : gs_async[gs_tid]) std::memcpy(c.dst, c.src, c.n);
    gs_async[gs_tid].clear();
}
"""

SMEM = "extern __shared__ __align__(16) unsigned char sort_smem[];"
WITHHOLD = ("            store_volatile(mine + j, ((tag | LB_PREFIX) << 32) | (prefix[j] + cnt[j]));",
            "            if (gs_publish_prefix(tile))\n"
            "                store_volatile(mine + j, ((tag | LB_PREFIX) << 32) | (prefix[j] + cnt[j]));")


def host_source(src: str) -> str:
    """sort.cu (or a variant's text) for g++: the dynamic shared memory the
    stub's, each launch a call of the stub's launcher."""
    assert src.count(SMEM) == 2 and src.count(WITHHOLD[0]) == 1
    src = src.replace(SMEM, "unsigned char* sort_smem = reinterpret_cast<unsigned char*>(gs_host_smem);")
    src = src.replace(*WITHHOLD)
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    assert launches == 2, launches  # the histogram and the pass kernel of each digit
    assert "__shared__" not in src and "asm" not in src
    return src


# the committed source, `sort_ablate.py`'s 11-bit digits, and the committed
# source with tiles of 1,024 keys (4 a thread), so that the look-back over
# more than 32 tiles runs in a few seconds on the fibers
HOST_VARIANTS = {"kernel": ([], []), "d11": sort_ablate.VARIANTS["d11"],
                 "small_tiles": ([(sort_ablate.ITEMS, "constexpr int ITEMS = 4;")], [])}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("sort_host")
    (tmp / "cuda_runtime.h").write_text(STUB + f"#define GS_HOST_SMS {HOST_SMS}\n" + EXTRA
                                        + EXTRA64 + EXTRA32)
    (tmp / "cuda_pipeline.h").write_text(PIPELINE)
    sources = ablation.variant_sources("sort", HOST_VARIANTS)
    jobs = {}
    for name in HOST_VARIANTS:
        (tmp / f"{name}.cpp").write_text(host_source(sources[name][0]))
        out = tmp / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [gxx, "-O1", "-fno-strict-aliasing", "-std=c++20", "-shared", "-fPIC", "-pthread",
             "-w", "-I", str(tmp), "-o", str(out), str(tmp / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
        lib = _kernels.open_library(out, "sort")
        lib.gs_set_withhold.argtypes = [ctypes.c_int]
        lib.gs_set_withhold.restype = None
        libs[name] = lib
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs["kernel"])
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # the launch counter as it was after the test: other tests in this
    # process read it
    monkeypatch.setattr(so.sort_instances, "launches", so.sort_instances.launches)
    yield host_libs["kernel"]
    host_libs["kernel"].gs_set_withhold(0)


def check_sort(keys, gid, key_bits, reps=1):
    """St' on the host against the twin, `reps` launches in a row (the
    state carries over); after each, its digit counters, its counter of
    finished blocks and its ticket are 0 again."""
    want = so.sort_instances_torch(keys, gid, key_bits)
    _, passes, digit_bits, tile = so.sort_layout(keys.shape[0], key_bits)
    fixed = -(-62 // digit_bits) << digit_bits  # MAX_PASSES x RADIX
    for _ in range(reps):
        before = so.sort_instances.launches
        got = so.sort_instances(keys, gid, key_bits)
        assert so.sort_instances.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state, _ = so._states[(torch.device("cpu"), digit_bits, tile)]
        words = state.view(torch.int32)
        assert not bool(words[:fixed].any()), "digit counters not back at 0"
        assert not bool(words[2 * fixed:2 * fixed + 2].any()), "done counter or ticket not 0"
    return passes, tile


def frame_keys(rng, k, key_bits, tiles, distinct_depths=None):
    """K1''s key layout: (tile << 32) | depth bits of a positive float32."""
    tile = rng.integers(0, tiles, k)
    if distinct_depths:
        depth = rng.choice(rng.uniform(0.21, 100.0, distinct_depths), k)
    else:
        depth = rng.uniform(0.21, 1e4, k)
    bits = depth.astype(np.float32).view(np.int32).astype(np.int64)
    keys = torch.from_numpy((tile.astype(np.int64) << 32) | bits)
    assert int(so.live_bits(keys).max()) < 2**key_bits
    return keys, torch.from_numpy(rng.permutation(k).astype(np.int32))


def test_many_duplicates(on_host):
    """Keys from 40 tiles and 25 depths (each key ~6 times), 44 key bits."""
    keys, gid = frame_keys(np.random.default_rng(1), 6000, 44, 40, distinct_depths=25)
    assert torch.unique(keys).numel() <= 1000
    passes, _ = check_sort(keys, gid, 44, reps=2)
    assert passes == -(-44 // so.sort_layout(6000, 44)[2])


def test_all_keys_equal(on_host):
    """Every key equal: the gids come out in slot order."""
    keys = torch.full((3000,), (77 << 32) | 0x3F800000, dtype=torch.int64)
    gid = torch.from_numpy(np.random.default_rng(2).permutation(3000).astype(np.int32))
    check_sort(keys, gid, 44)
    assert torch.equal(so.sort_instances(keys, gid, 44)[1], gid)


def test_one_tile(on_host):
    keys, gid = frame_keys(np.random.default_rng(3), 4500, 44, 1)
    keys |= 4321 << 32
    check_sort(keys, gid, 44)


def test_46_bit_keys(on_host):
    """3840x2160: 32,400 tiles, key_bits 46."""
    assert so.sort_key_bits(240 * 135) == 46
    keys, gid = frame_keys(np.random.default_rng(4), 6000, 46, 240 * 135)
    assert int(so.live_bits(keys).max()) >= 2**45
    check_sort(keys, gid, 46)


@pytest.mark.parametrize("k", [1, 2, 8193])
def test_k_one_and_partial_tiles(on_host, k):
    keys, gid = frame_keys(np.random.default_rng(5), k, 44, 8160)
    _, tile = check_sort(keys, gid, 44, reps=2 if k < 3 else 1)
    assert k == 1 or k % tile


def test_withheld_inclusive_counts(on_host, host_libs, monkeypatch):
    """41 tiles (of 1,024 keys: `small_tiles`); with only every 37th tile's
    inclusive counts published, a look-back sums up to 36 tiles' counts.
    16-bit keys with duplicates, two passes (the fibers' time goes with
    keys times passes)."""
    lib = host_libs["small_tiles"]
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    _, passes, _, tile = so.sort_layout(1, 16)
    assert (passes, tile) == (2, 1024)
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(rng.integers(0, 1 << 16, 40 * tile + 77))
    gid = torch.from_numpy(rng.permutation(keys.shape[0]).astype(np.int32))
    lib.gs_set_withhold(37)
    try:
        check_sort(keys, gid, 16)
    finally:
        lib.gs_set_withhold(0)


@pytest.mark.parametrize("tight", [True, False])
def test_expand_keys_of_a_seeded_screen(on_host, tight):
    """The keys and gids of K1''s expand (twin) on the JAX projection's
    seeded screen."""
    _, ts, gx, gy = screen_pair(3, 1500, tight)
    tables = tb._emission_tables_torch(ts, 16, tight)
    keys, gid, _ = tb._expand_instances_torch(*tables[:5], ts, tables[5], gx, tight)
    assert keys.shape[0] > 1000
    check_sort(keys, gid, so.sort_key_bits(gx * gy))


def test_eleven_bit_digits(on_host, host_libs, monkeypatch):
    """`sort_ablate.py`'s 11-bit digits (2,048 bins; 4 passes of 44 bits,
    5 of 46) on duplicates and on 46-bit keys with withheld counts."""
    lib = host_libs["d11"]
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    _, passes, digit_bits, tile = so.sort_layout(1, 44)
    assert (passes, digit_bits) == (4, 11)
    rng = np.random.default_rng(7)
    check_sort(*frame_keys(rng, tile + 5, 44, 40, distinct_depths=25), 44)
    lib.gs_set_withhold(2)
    try:
        check_sort(*frame_keys(rng, 2 * tile + 5, 46, 240 * 135), 46)
    finally:
        lib.gs_set_withhold(0)


@pytest.mark.parametrize("tight", [True, False])
def test_expand_keys_meet_the_precondition(tight):
    """K1''s keys: bit 31 clear and the live bits under 2^key_bits, on the
    seeded screen and on the edge rows (those with no NaN run)."""
    _, ts, gx, gy = screen_pair(3, 1500, tight)
    edge, _ = emission_edge_screen(device="cpu")
    for screen, grid in ((ts, (gx, gy)), (edge, (120, 68))):
        tables = tb._emission_tables_torch(screen, 16, tight)
        keep = tables[0][:, 3] >= 0  # a NaN run: INT_MIN tiles on the host
        if not bool(keep.all()):
            screen = rows(screen, keep)
            tables = tb._emission_tables_torch(screen, 16, tight)
        keys, _, _ = tb._expand_instances_torch(*tables[:5], screen, tables[5], grid[0], tight)
        assert keys.shape[0] > 1000
        assert not bool((keys & (1 << 31)).any())
        assert int(so.live_bits(keys).max()) < 2 ** so.sort_key_bits(grid[0] * grid[1])


def test_sort_instances_refuses_what_the_kernel_does_not_take(monkeypatch):
    keys = torch.arange(10, dtype=torch.int64)
    gid = torch.arange(10, dtype=torch.int32)
    monkeypatch.setattr(so.sort_instances, "launches", 0)
    with pytest.raises(ValueError, match="CUDA"):
        so.sort_instances(keys, gid, 44)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for bad in ((keys.to(torch.int32), gid, 44), (keys, gid.to(torch.int64), 44),
                (keys, gid[:9], 44), (keys, gid, 0), (keys, gid, 63)):
        with pytest.raises(ValueError, match="sort_instances"):
            so.sort_instances(*bad)
    with pytest.raises(ValueError, match="aligned"):
        so.sort_instances(torch.zeros(11, dtype=torch.int64)[1:], gid, 44)
    big = 2**31
    with pytest.raises(ValueError, match="2\\^31"):
        so.sort_instances(torch.zeros(1, dtype=torch.int64).expand(big),
                          torch.zeros(1, dtype=torch.int32).expand(big), 44)
    # K = 0 launches nothing
    got = so.sort_instances(keys[:0], gid[:0], 44)
    assert got[0].shape == (0,) and got[1].shape == (0,)
    assert so.sort_instances.launches == 0
