"""The instance sort's CUDA sources run on the host, through the wrapper
`sort_instances`, against its plain twin `sort_instances_torch` bit for
bit: kernel St'' (`gsplat_tpu_torch/csrc/sort.cu`, the route up to
`ONESWEEP_MIN_KEYS` keys) and St' (`csrc/sort_onesweep.cu`, the route
above it, forced here at a few thousand keys).

The sources are built with `g++ -O1` against the stub `cuda_runtime.h` of
`tests/test_torch_loss_kernel_host.py` (a block's threads as fibers on one
host thread, barriers and shuffles between them, the blocks one after
another), extended as `tests/test_torch_emission_tables_host.py` extends
it (warp votes, 64-bit shuffles, a `__nanosleep` that yields), and here
with 32-bit shuffles, `__match_any_sync`, `__popc`, `__ldcg`, a shared
`atomicMax` and the asynchronous copies (queued, landed when their thread
waits). The dynamic shared memory is the stub's, filled with NaN bytes
before each block, so a value read before it was written shows. The stub
has three SMs: St'''s count and scatter run in up to three blocks (a block
at least 4,096 slots), its segment kernel in up to three blocks, each
taking every third tile. St'''s launches go through a launcher of this
file that can run a grid's blocks in reverse order, so that the blocks
reserve their ranges of each tile's bucket last to first.

St'' cases: tiles of CAP - 1, CAP and CAP + 1 keys; tiles over and under
CAP together, with empty tiles between; all keys in one tile, over CAP
(the big route's merges); duplicates, where the slot order decides;
46-bit keys (3840x2160's 32,400 tiles); K = 1 and K not a multiple of a
block; the reservations made last block first; the real keys of K1''s
expand on the JAX projection's seeded screen. Each sort runs twice in a
row, so its counters must be 0 again after each launch; the count
kernel's tiles over CAP and largest tile are checked against the keys.
St' cases: its look-back over many tiles (with all but every k-th tile's
inclusive counts withheld by a host edit) and its 11-bit digits; keys too
wide for St'''s tile counters (47 and 62 bits) at a few thousand keys,
which take St' by their route; and the binning of a 4096x2160 frame
(34,560 tiles, the twins' tables and the host St') against the JAX
package's `bin_gaussians`. And the
expand's keys meet the precondition (bit 31 clear, the live bits under
2^key_bits) on that screen and on `synthetic.emission_edge_screen`. The
card runs the sort on the flagship frames and adversarial keys
(`chip_smoke.py`).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax

from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops import binning as jb
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import sort as so
from gsplat_tpu_torch.scripts import ablation, sort_ablate
from gsplat_tpu_torch.synthetic import emission_edge_screen
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_binning import screen_pair, to_port
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
inline unsigned atomicMax(unsigned* p, unsigned v) { unsigned o = *p; *p = o > v ? o : v; return o; }
struct longlong2 { long long x, y; };

// St'''s launches: the stub's launcher, the blocks last to first on request
inline int gs_reverse = 0;
extern "C" void gs_set_reverse(int r) { gs_reverse = r; }
template <typename K, typename... A>
void gs_sort_launch(K kernel, dim3 grid, dim3 block, int smem, A... args)
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
    for (unsigned i = 0; i < grid.x; ++i) {
        std::memset(gs_host_smem, 0xff, sizeof gs_host_smem);  // NaN
        blockIdx = {gs_reverse ? grid.x - 1 - i : i, 0, 0};
        gs_run_block((int)(block.x * block.y * block.z));
    }
}
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
HOST_SMEM = "unsigned char* sort_smem = reinterpret_cast<unsigned char*>(gs_host_smem);"
WITHHOLD = ("            store_volatile(mine + j, ((tag | LB_PREFIX) << 32) | (prefix[j] + cnt[j]));",
            "            if (gs_publish_prefix(tile))\n"
            "                store_volatile(mine + j, ((tag | LB_PREFIX) << 32) | (prefix[j] + cnt[j]));")
# St'''s state (`csrc/sort.cu`), in 32-bit words: the counter of finished
# count blocks, the route's counts, then the tile counters
LAYOUT = ("constexpr int DONE = 0;", "constexpr long long COUNTS = 16;",
          "constexpr int MAX_BINS = 1 << MAX_TILE_BITS;", "constexpr int MAX_TILE_BITS = 15;")
DONE, COUNTS, MAX_BINS = 0, 16, 1 << 15


def host_source(src: str) -> str:
    """sort.cu for g++: the dynamic shared memory the stub's, each launch a
    call of this file's launcher."""
    assert src.count(SMEM) == 3 and all(src.count(line) == 1 for line in LAYOUT)
    src = src.replace(SMEM, HOST_SMEM)
    src, launches = LAUNCH.subn(r"gs_sort_launch(\1, \2, \3, \4, \6);", src)
    assert launches == 3, launches  # count, scatter, segment
    assert "__shared__" not in src and "asm" not in src
    return src


def onesweep_host_source(src: str) -> str:
    """St''s source (or a variant's text) for g++, with the withhold edit
    on its look-back."""
    assert src.count(SMEM) == 2 and src.count(WITHHOLD[0]) == 1
    src = src.replace(SMEM, HOST_SMEM).replace(*WITHHOLD)
    src, launches = LAUNCH.subn(r"gs_host_launch(\1, \2, \3, \4, \6);", src)
    assert launches == 2, launches  # the histogram and the pass kernel of each digit
    assert "__shared__" not in src and "asm" not in src
    return src


# St' as committed, its 11-bit digits, and its tiles of 1,024 keys (4 a
# thread), so that the look-back over more than 32 tiles runs in a few
# seconds on the fibers
ONESWEEP_VARIANTS = {"onesweep": ([], []),
                     "onesweep_d11": sort_ablate.ONESWEEP_VARIANTS["onesweep_d11"],
                     "onesweep_small_tiles": ([("constexpr int ITEMS = 16;",
                                                "constexpr int ITEMS = 4;")], [])}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp = tmp_path_factory.mktemp("sort_host")
    (tmp / "cuda_runtime.h").write_text(STUB + f"#define GS_HOST_SMS {HOST_SMS}\n" + EXTRA
                                        + EXTRA64 + EXTRA32)
    (tmp / "cuda_pipeline.h").write_text(PIPELINE)
    texts = {"kernel": host_source((_kernels.CSRC / "sort.cu").read_text())}
    onesweeps = ablation.variant_sources("sort_onesweep", ONESWEEP_VARIANTS)
    texts.update({name: onesweep_host_source(text) for name, (text, _) in onesweeps.items()})
    jobs = {}
    for name, text in texts.items():
        (tmp / f"{name}.cpp").write_text(text)
        out = tmp / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [gxx, "-O1", "-fno-strict-aliasing", "-std=c++20", "-shared", "-fPIC", "-pthread",
             "-w", "-I", str(tmp), "-o", str(out), str(tmp / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
        if name == "kernel":
            lib = _kernels.open_library(out, "sort")
            lib.gs_set_reverse.argtypes = [ctypes.c_int]
            lib.gs_set_reverse.restype = None
        else:
            lib = _kernels.open_library(out, "sort_onesweep")
            lib.gs_set_withhold.argtypes = [ctypes.c_int]
            lib.gs_set_withhold.restype = None
        libs[name] = lib
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    monkeypatch.setattr(_kernels, "load", lambda name: host_libs["kernel" if name == "sort"
                                                                   else "onesweep"])
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # the launch counter as it was after the test: other tests in this
    # process read it
    monkeypatch.setattr(so.sort_instances, "launches", so.sort_instances.launches)
    yield host_libs["kernel"]
    host_libs["kernel"].gs_set_reverse(0)


def check_sort(keys, gid, key_bits, reps=2):
    """St'' on the host against the twin, `reps` launches in a row (the
    state carries over); after each, its counter of finished blocks and
    its tile counters are 0 again, and the count kernel's tiles over CAP
    and largest tile are the keys' own. Returns (tiles over CAP, largest
    tile)."""
    want = so.sort_instances_torch(keys, gid, key_bits)
    counts = torch.bincount((keys >> 32).long())
    cap = so.sort_layout(keys.shape[0], key_bits).cap
    for _ in range(reps):
        before = so.sort_instances.launches
        got = so.sort_instances(keys, gid, key_bits)
        assert so.sort_instances.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        words = so._states[torch.device("cpu")].view(torch.int32)
        assert int(words[DONE]) == 0, "counter of finished count blocks not back at 0"
        assert not bool(words[COUNTS:COUNTS + MAX_BINS].any()), "tile counters not back at 0"
        stats = so.sort_stats("cpu")
        assert stats == (int((counts > cap).sum()), int(counts.max()))
    return stats


def frame_keys(rng, k, key_bits, tiles, distinct_depths=None):
    """K1''s key layout: (tile << 32) | depth bits of a positive float32;
    `tiles` a count (ids 0 ... tiles - 1) or the ids to draw from."""
    tile = rng.integers(0, tiles, k) if np.isscalar(tiles) else rng.choice(tiles, k)
    if distinct_depths:
        depth = rng.choice(rng.uniform(0.21, 100.0, distinct_depths), k)
    else:
        depth = rng.uniform(0.21, 1e4, k)
    bits = depth.astype(np.float32).view(np.int32).astype(np.int64)
    keys = torch.from_numpy((np.asarray(tile, dtype=np.int64) << 32) | bits)
    assert int(so.live_bits(keys).max()) < 2**key_bits
    return keys, torch.from_numpy(rng.permutation(k).astype(np.int32))


def tiles_of_sizes(rng, sizes, key_bits=44):
    """Keys whose tiles (ids spread over the grid, empty ones between)
    hold `sizes` keys each, in a random slot order, with duplicate depths."""
    ids = np.sort(rng.choice(2 ** (key_bits - 31), len(sizes), replace=False))
    tile = rng.permutation(np.repeat(ids, sizes))
    keys, gid = frame_keys(rng, tile.size, key_bits, 1, distinct_depths=max(2, tile.size // 4))
    return keys | torch.from_numpy(tile.astype(np.int64) << 32), gid


def test_many_duplicates(on_host):
    """Keys from 40 tiles and 25 depths (each key ~6 times), 44 key bits."""
    keys, gid = frame_keys(np.random.default_rng(1), 6000, 44, 40, distinct_depths=25)
    assert torch.unique(keys).numel() <= 1000
    assert check_sort(keys, gid, 44) == (0, int(torch.bincount((keys >> 32).long()).max()))


def test_all_keys_equal(on_host):
    """Every key equal, 9,000 in one tile (over CAP): the gids come out in
    slot order."""
    keys = torch.full((9000,), (77 << 32) | 0x3F800000, dtype=torch.int64)
    gid = torch.from_numpy(np.random.default_rng(2).permutation(9000).astype(np.int32))
    assert check_sort(keys, gid, 44) == (1, 9000)
    assert torch.equal(so.sort_instances(keys, gid, 44)[1], gid)


def test_one_tile(on_host):
    """20,000 keys in one tile: its CAP runs merged over several levels."""
    keys, gid = frame_keys(np.random.default_rng(3), 20000, 44, 1)
    keys |= 4321 << 32
    assert check_sort(keys, gid, 44) == (1, 20000)


def test_46_bit_keys(on_host):
    """3840x2160: 32,400 tiles, key_bits 46 (32,768 bins); the keys on 300
    of the tiles, some above 2^14."""
    assert so.sort_key_bits(240 * 135) == 46
    rng = np.random.default_rng(4)
    keys, gid = frame_keys(rng, 6000, 46, rng.choice(240 * 135, 300, replace=False))
    assert int(so.live_bits(keys).max()) >= 2**45
    check_sort(keys, gid, 46)


@pytest.mark.parametrize("k", [1, 2, 8193])
def test_k_one_and_partial_tiles(on_host, k):
    """K = 1, 2 and a K that is not a multiple of the count's blocks."""
    keys, gid = frame_keys(np.random.default_rng(5), k, 44, 40)
    blocks = so.sort_layout(k, 44).blocks
    assert k < 3 or blocks == HOST_SMS  # blocks of 2,732 slots, the last 2,729
    check_sort(keys, gid, 44)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_tile_at_cap(on_host, delta):
    """One tile of CAP - 1, CAP or CAP + 1 keys (the last over CAP: the big
    route), beside small ones."""
    cap = so.sort_layout(1, 44).cap
    keys, gid = tiles_of_sizes(np.random.default_rng(10 + delta), [cap + delta, 37, 1, 300])
    assert check_sort(keys, gid, 44) == (int(delta > 0), cap + delta)


def test_tiles_over_and_under_cap(on_host):
    """Tiles of 10 CAP, 4 CAP + 1 and CAP + 1 keys (the big route), CAP and
    WARP_CAP + 1 (a block's), WARP_CAP (a warp's) among small ones and
    empty ones: the block's tiles first, the big route's first of them."""
    layout = so.sort_layout(1, 44)
    cap, warp_cap = layout.cap, layout.warp_cap
    sizes = [3, 10 * cap, 100, cap + 1, 1, cap, 4 * cap + 1, 700, warp_cap + 1, warp_cap]
    keys, gid = tiles_of_sizes(np.random.default_rng(11), sizes)
    assert check_sort(keys, gid, 44) == (3, 10 * cap)


def test_empty_tiles(on_host):
    """The first and the last tile ids of the grid and one between, all
    others empty; and a grid whose keys all lie in its last tile."""
    rng = np.random.default_rng(12)
    check_sort(*frame_keys(rng, 900, 44, np.array([0, 4000, 8191])), 44)
    check_sort(*frame_keys(rng, 50, 44, np.array([8191])), 44)


def test_slot_order_decides_ties(on_host):
    """Runs of equal keys in several tiles with a random-permutation gid:
    each run's gids come out in slot order, whatever the buckets' order."""
    rng = np.random.default_rng(13)
    keys, gid = frame_keys(rng, 5000, 44, np.array([3, 9, 2000]), distinct_depths=3)
    check_sort(keys, gid, 44)
    keys_sorted, gid_sorted = so.sort_instances(keys, gid, 44)
    for key in torch.unique(keys)[:4]:
        assert torch.equal(gid_sorted[keys_sorted == key], gid[keys == key])


def test_reversed_reservations(on_host):
    """Every kernel's blocks run last to first: each tile's bucket holds the
    blocks' ranges in reverse order (and the ranks within a block in the
    fibers' order, not the slots'); the result is the same."""
    rng = np.random.default_rng(14)
    keys, gid = tiles_of_sizes(rng, [4000, 3000, 900, 40, 2500])
    assert so.sort_layout(keys.shape[0], 44).blocks == HOST_SMS
    for reverse in (0, 1):
        on_host.gs_set_reverse(reverse)
        check_sort(keys, gid, 44)


@pytest.mark.parametrize("tight", [True, False])
def test_expand_keys_of_a_seeded_screen(on_host, tight):
    """The keys and gids of K1''s expand (twin) on the JAX projection's
    seeded screen."""
    _, ts, gx, gy = screen_pair(3, 1500, tight)
    tables = tb._emission_tables_torch(ts, 16, tight)
    keys, gid, _ = tb._expand_instances_torch(*tables[:5], ts, tables[5], gx, tight)
    assert keys.shape[0] > 1000
    check_sort(keys, gid, so.sort_key_bits(gx * gy))


def check_onesweep(lib, keys, gid, key_bits):
    """St' (a build `lib` of it) through `sort_instances`, its route forced,
    on the host against the twin; after the launch its digit counters, its
    counter of finished blocks and its ticket are 0."""
    want = so.sort_instances_torch(keys, gid, key_bits)
    with ablation.loaded("sort_onesweep", lib), sort_ablate.on_route("onesweep"):
        got = so.sort_instances(keys, gid, key_bits)
        _, _, digit_bits, tile = so.onesweep_layout(1, key_bits)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fixed = -(-62 // digit_bits) << digit_bits  # MAX_PASSES x RADIX
    state, _ = so._onesweep_states[(keys.device, digit_bits, tile)]
    words = state.view(torch.int32)
    assert not bool(words[:fixed].any()), "digit counters not back at 0"
    assert not bool(words[2 * fixed:2 * fixed + 2].any()), "done counter or ticket not 0"


@pytest.mark.parametrize("key_bits,tiles", [(47, 256 * 135), (62, 2**31)])
def test_wide_keys_take_st_prime_at_any_count(on_host, key_bits, tiles):
    """Keys too wide for St'''s tile counters (47 bits: 4096x2160's 34,560
    tiles; 62 bits: tile ids up to 2^31 - 1), 3,000 of them (far under
    ONESWEEP_MIN_KEYS): `sort_instances` takes St' unforced, bit for bit
    the twin, and leaves St'''s state untouched. St'' itself refuses them."""
    assert so.sort_key_bits(256 * 135) == 47
    k = 3000
    assert k <= so.ONESWEEP_MIN_KEYS
    assert (so.route(k, 47), so.route(k, 46)) == ("onesweep", "segmented")
    assert so.route(so.ONESWEEP_MIN_KEYS + 1, 46) == "onesweep"
    rng = np.random.default_rng(key_bits)
    ids = np.append(rng.integers(1 << 15, tiles, 60), tiles - 1)
    keys, gid = frame_keys(rng, k, key_bits, ids, distinct_depths=500)
    assert int(so.live_bits(keys).max()) >= 2 ** (key_bits - 1)
    states = dict(so._states)
    want = so.sort_instances_torch(keys, gid, key_bits)
    for _ in range(2):
        got = so.sort_instances(keys, gid, key_bits)
        assert so.sort_instances.last_route == "onesweep"
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert so._states == states
    with sort_ablate.on_route("segmented"):
        assert so.route(k, key_bits) == "onesweep"
    with pytest.raises(ValueError, match="key_bits"):
        so.sort_layout(k, key_bits)
    with pytest.raises(ValueError, match="key_bits"):
        so._sort_segmented(keys, gid, key_bits, torch.empty_like(keys), torch.empty_like(gid))


def test_a_4096x2160_grid_bins_as_the_jax_package_does(on_host):
    """The port's binning on a 4096x2160 grid (34,560 tiles, key_bits 47),
    its sort the host build of St' (taken by its route), against the JAX
    package's `bin_gaussians` (its jnp route) on the same screen: the
    instance order and the per-tile ranges equal, at JAX overflow 0."""
    sc = make_test_scene(np.random.default_rng(21), n=300, width=4096, height=2160,
                         sh_degree=2)
    sc["log_scaling"] -= np.float32(np.log(30.0))  # splats of a few tiles at this size
    params, camera, alive = scene_to_inputs(sc)
    settings = make_render_settings(sh_degree=2, instance_capacity=1 << 16, tight_cull=True)
    gx, gy = (camera.width + 15) // 16, (camera.height + 15) // 16
    assert (gx, gy) == (256, 135) and so.sort_key_bits(gx * gy) == 47
    js = jax.jit(lambda p, a: preprocess(p, a, camera, settings, gx, gy))(params, alive)
    ts = to_port(js)
    jbins = jax.jit(lambda s: jb.bin_gaussians(s, gx, gy, 1 << 16, 16, tight_cull=True))(js)
    k = int(jbins.num_instances)
    assert int(jbins.overflow) == 0 and k > 1000
    got = tb._pack(ts, gx, gy, 16, True, "float32", tb._emission_tables_torch,
                   tb._expand_instances_torch, so.sort_instances, tb._pack_instances_torch)
    assert so.sort_instances.last_route == "onesweep" and got.num_instances == k
    for f in ("tile_start", "tile_end"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jbins, f)))
    for f in ("tile_id", "gauss_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jbins, f))[:k])


def test_route_by_key_count(on_host, monkeypatch):
    """`sort_instances` takes St' above ONESWEEP_MIN_KEYS keys and St'' up
    to it; both give the twin's result."""
    monkeypatch.setattr(so, "ONESWEEP_MIN_KEYS", 3000)
    monkeypatch.setattr(so, "_states", {})
    monkeypatch.setattr(so, "_onesweep_states", {})
    assert (so.route(3001, 44), so.route(3000, 44)) == ("onesweep", "segmented")
    rng = np.random.default_rng(15)
    keys, gid = frame_keys(rng, 3001, 44, 40, distinct_depths=100)
    got = so.sort_instances(keys, gid, 44)
    assert all(torch.equal(a, b) for a, b in zip(got, so.sort_instances_torch(keys, gid, 44)))
    assert so._onesweep_states and not so._states
    check_sort(keys[:3000], gid[:3000], 44, reps=1)
    assert so._states


def test_withheld_inclusive_counts(on_host, host_libs):
    """St' over 41 tiles (of 1,024 keys); with only every 37th tile's
    inclusive counts published, a look-back sums up to 36 tiles' counts.
    16-bit keys with duplicates, two passes (the fibers' time goes with
    keys times passes)."""
    lib = host_libs["onesweep_small_tiles"]
    with ablation.loaded("sort_onesweep", lib):
        _, passes, _, tile = so.onesweep_layout(1, 16)
    assert (passes, tile) == (2, 1024)
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(rng.integers(0, 1 << 16, 40 * tile + 77))
    gid = torch.from_numpy(rng.permutation(keys.shape[0]).astype(np.int32))
    lib.gs_set_withhold(37)
    try:
        check_onesweep(lib, keys, gid, 16)
    finally:
        lib.gs_set_withhold(0)


def test_eleven_bit_digits(on_host, host_libs):
    """St' with 11-bit digits (2,048 bins; 4 passes of 44 bits, 5 of 46)
    on duplicates and on 46-bit keys with withheld counts; and as
    committed (8-bit digits) on the same keys."""
    lib = host_libs["onesweep_d11"]
    with ablation.loaded("sort_onesweep", lib):
        _, passes, digit_bits, tile = so.onesweep_layout(1, 44)
    assert (passes, digit_bits) == (4, 11)
    rng = np.random.default_rng(7)
    dups = frame_keys(rng, tile + 5, 44, 40, distinct_depths=25)
    wide = frame_keys(rng, 2 * tile + 5, 46, 240 * 135)
    check_onesweep(lib, *dups, 44)
    check_onesweep(host_libs["onesweep"], *dups, 44)
    lib.gs_set_withhold(2)
    try:
        check_onesweep(lib, *wide, 46)
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
    # key_bits over 62: wider than St' sorts (47 ... 62 take St' at any K)
    for bad in ((keys.to(torch.int32), gid, 44), (keys, gid.to(torch.int64), 44),
                (keys, gid[:9], 44), (keys, gid, 0), (keys, gid, 63)):
        with pytest.raises(ValueError, match="sort_instances"):
            so.sort_instances(*bad)
    for taken in (1, 46, 47, 62):
        so._check(keys, gid, taken)
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
