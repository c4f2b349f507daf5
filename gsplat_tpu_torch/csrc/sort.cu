// Kernel St'': the instance sort, on Hopper (sm_90a), as a segmented sort.
//
// St'' replaces no Pallas kernel: the JAX package leaves the sort of its
// (tile, depth bits, gaussian id) instance keys to XLA (`lax.sort`,
// gsplat_tpu/ops/binning.py:758). `ops/sort.py:sort_instances` takes St''
// for up to ONESWEEP_MIN_KEYS (2^23) keys and the port's first kernel for
// it, St' (`sort_onesweep.cu`: an LSD radix sort over all of the key's live
// bits, a histogram and six 8-bit passes through device memory), for more.
//
// The key is K1''s `(tile << 32) | depth_bits`. The depth bits are those
// of a float32 above 0.2 (the projection marks only depth > 0.2 valid, and
// invalid rows emit no slot), or +inf: positive, so bit 31 of every key is
// 0 and the depth lives in bits 0-30. The result must be
// `torch.sort(keys, stable=True)` and `gid[perm]` bit for bit: the order
// (tile, depth bits, slot), the slot being the key's index in the input.
//
// The tile field only partitions the keys (8,160 tiles at 1920x1080, 448
// keys a tile on the flagship frame), and the depth bits only order them
// within a tile, few enough to sort on chip. So:
//
//   sort_instances_count    counts each tile's keys (a shared-memory
//                           histogram a block over a contiguous run of
//                           slots) and reserves the block's range in each
//                           tile it touches with one global atomic add a
//                           non-empty bin, which returns the range's start
//                           in the tile. The last block to finish writes the
//                           exclusive tile offsets and the order in which the
//                           segment kernel takes the tiles (those over
//                           WARP_CAP first), and returns the counters to 0.
//   sort_instances_scatter  the same runs of slots: each key goes to its
//                           tile's bucket at the block's reserved start plus
//                           a rank from a shared-memory atomic, as the value
//                           v = (depth_bits << 32) | slot. A block does the
//                           tiles in 2^SCATTER_PART_BITS ranges, one after
//                           another, reading its keys once a range, so that
//                           the buckets being written at a time stay in L2
//                           until their sectors are whole.
//   sort_instances_segment  each bucket sorted by v on chip and written out
//                           as (tile << 32) | (v >> 32) with the gid of slot
//                           v & 0x7fffffff, to consecutive addresses. A tile
//                           of at most WARP_CAP keys takes one warp: E values
//                           a lane (E = 4 ... 32, by the tile's size) sorted
//                           in registers by a bitonic network, then runs of E,
//                           2 E, ... merged pairwise through the warp's shared
//                           memory (merge path), with no barrier but the
//                           warp's. A larger tile takes the block: up to CAP
//                           keys the same merge sort over the block (ITEMS
//                           values a thread); over CAP the big route, chosen
//                           on the device by the count: each CAP run sorted
//                           so, then runs merged pairwise, level by level,
//                           through device memory (the bucket and the output
//                           keys as its two buffers; each level's CAP-output
//                           chunks found by a merge-path search, then merged
//                           in shared memory), the last level writing the
//                           keys. The blocks take the tiles over WARP_CAP
//                           first (the count orders them first), the warps
//                           the rest.
//
// Stability rides in the value: v holds the slot below the depth bits, so
// v is unique and its order is the stable order. Neither the reservations
// (an atomic's order across blocks) nor the ranks inside a block need any
// order, so there is no look-back and no ticket, and the result does not
// depend on which block reserves first. The bucket holds v alone: the slot
// in it finds the gid when the tile is written out.
//
// The grid of tiles: 2^(key_bits - 31) bins, one per tile id, at most
// MAX_BINS (32,768: key_bits 46, 3840x2160's 32,400 tiles); a count or
// scatter block holds one 32-bit counter a bin in shared memory (128 KB at
// 46 bits). That limit is St'''s own, not the sort's: `sort_instances`
// sends wider keys (4096x2160's 34,560 tiles, key_bits 47) to St', which
// takes up to 62 bits, whatever K.
//
// State: one buffer per device, zeroed when allocated: the counter of
// finished count blocks and the tile counters return to 0 in every launch;
// the offsets, the tile order and each block's reserved starts are written
// anew before they are read. Launches on one stream share it, not launches
// on two streams at once.
//
// Bound on the card: bytes, one read and one write of the key and the gid,
// 24 bytes an instance (87.8 MB on the 3,659,464 instances of the 1080p
// flagship frame). The design moves 8 bytes an instance to count, 8 in
// (once a range, from L2 after the first) and 8 out to scatter, 8 in, 12
// out and the gid's 4 gathered to sort each tile: 40 bytes from device
// memory at the least. Its parts and choices (ranges, CAP, E, the warp's
// share) are timed by `scripts/sort_ablate.py`, which also times a frame of
// six times the flagship's instances: there the buckets outgrow L2 and
// most tiles are over CAP, and St' is the faster (the reason for the two
// routes).

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;             // a segment block
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                 // values a thread of a block sort at most
constexpr int CAP = THREADS * ITEMS;     // the largest tile a block sorts in one piece
constexpr int WARP_ITEMS = 32;           // values a lane of a warp sort at most
constexpr int WARP_CAP = 32 * WARP_ITEMS;  // the largest tile a warp sorts
constexpr int CS_THREADS = 1024;         // a count or scatter block
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_PER_SM = 1;             // count or scatter blocks an SM at most
constexpr int SCATTER_PART_BITS = 3;     // the scatter's ranges of tiles: 2^bits
constexpr int MAX_TILE_BITS = 15;
constexpr int MAX_BINS = 1 << MAX_TILE_BITS;
constexpr int MAX_KEY_BITS = 31 + MAX_TILE_BITS;
constexpr int CHUNK_MIN = 4096;          // slots a count or scatter block at least
constexpr u64 PAST = ~0ull;              // after every value (a value's bit 63 is 0)
static_assert((ITEMS & (ITEMS - 1)) == 0, "merge widths double from ITEMS");
static_assert(WARP_CAP < CAP, "the block sorts the tiles a warp does not");

// the state, in 32-bit words: a head, then the tables at fixed places, so
// that a launch over another grid of tiles finds its counters at 0
constexpr int DONE = 0;         // finished count blocks, 0 before and after a launch
constexpr int N_BIG = 1;        // tiles over CAP, of the last launch
constexpr int LARGEST = 2;      // the largest tile's count, of the last launch
constexpr int N_BLOCK = 3;      // tiles over WARP_CAP, of the last launch
constexpr int N_TILES = 4;      // tiles that hold a key, of the last launch
constexpr int TICKET_BLOCK = 5;  // the segment kernel's next tile for a block,
constexpr int TICKET_WARP = 6;   // for a warp: set to 0 by the count
// the tiles' size classes, the order in which the segment kernel takes
// them: over CAP, over WARP_CAP, then a warp's by halves of WARP_CAP down
// to an eighth, the rest, the empty ones (not taken)
constexpr int CLASSES = 7;
constexpr long long COUNTS = 16;                        // (MAX_BINS,) 0 before and after
constexpr long long OFFSETS = COUNTS + MAX_BINS;        // (MAX_BINS + 1,) exclusive
constexpr long long ORDER = OFFSETS + MAX_BINS + 2;     // (MAX_BINS,) those over WARP_CAP first
constexpr long long RESERVED = ORDER + MAX_BINS;        // (blocks, bins) each block's starts

// shared memory of a segment block: a tile's values, one slot of padding
// every 16 (a thread's consecutive values fall on distinct banks), and the
// big route's chunk splits; or each warp's tile
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }
constexpr size_t BLOCK_SMEM = pad(CAP) * 8 + (THREADS + 1) * 4;
constexpr size_t WARP_SMEM = WARPS * pad(WARP_CAP) * 8;
constexpr size_t SEG_SMEM = (BLOCK_SMEM > WARP_SMEM ? BLOCK_SMEM : WARP_SMEM) + 16;
constexpr int SCANNED = CLASSES + 1;  // a count block's scanned values: keys, classes
constexpr size_t HEAD_SMEM = (SCANNED + 2) * CS_WARPS * 4;

__device__ __forceinline__ int size_class(unsigned c)
{
    return c > (unsigned)CAP ? 0 : c > (unsigned)WARP_CAP ? 1 : c > WARP_CAP / 2 ? 2
         : c > WARP_CAP / 4 ? 3 : c > WARP_CAP / 8 ? 4 : c > 0 ? 5 : 6;
}

// The warp's inclusive scan of x across its lanes.
__device__ __forceinline__ unsigned warp_scan(unsigned x, int lane)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += u;
    }
    return x;
}

// The block's exclusive scan of each thread's N values, in place, and
// their totals: each warp's scan, then warp 0's over the warps' sums.
// `s_w` holds (N + 1) x CS_WARPS words.
template <int N>
__device__ __forceinline__ void scan_n(unsigned (&a)[N], unsigned (&total)[N], unsigned* s_w)
{
    static_assert(CS_WARPS == 32, "warp 0 scans one lane a warp");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned inc[N];
#pragma unroll
    for (int c = 0; c < N; ++c) inc[c] = warp_scan(a[c], lane);
    if (lane == 31)
#pragma unroll
        for (int c = 0; c < N; ++c) s_w[c * CS_WARPS + warp] = inc[c];
    __syncthreads();
    if (warp == 0)
#pragma unroll
        for (int c = 0; c < N; ++c) {
            const unsigned x = s_w[c * CS_WARPS + lane], y = warp_scan(x, lane);
            s_w[c * CS_WARPS + lane] = y - x;  // the warps before
            if (lane == 31) s_w[N * CS_WARPS + c] = y;
        }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < N; ++c) {
        a[c] = s_w[c * CS_WARPS + warp] + inc[c] - a[c];
        total[c] = s_w[N * CS_WARPS + c];
    }
    __syncthreads();
}

__global__ void __launch_bounds__(CS_THREADS) sort_instances_count(
    const long long* __restrict__ keys,  // (K,), 16-byte aligned
    int k, int chunk,                    // a block's slots: [b chunk, (b + 1) chunk), chunk even
    int tile_bits,
    unsigned* st)                        // the state
{
    extern __shared__ __align__(16) unsigned char sort_smem[];
    const int t = threadIdx.x, nbins = 1 << tile_bits;
    unsigned* s_h = reinterpret_cast<unsigned*>(sort_smem);  // (nbins,)
    unsigned* s_w = s_h + nbins;                              // ((SCANNED + 2) CS_WARPS,)

    for (int i = t; i < nbins; i += CS_THREADS) s_h[i] = 0;
    __syncthreads();
    // the tile ids of the block's slots, two keys a load
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = lo + chunk < k ? lo + chunk : (long long)k;
    const longlong2* two = reinterpret_cast<const longlong2*>(keys);
    for (long long p = lo / 2 + t; 2 * p < hi; p += CS_THREADS) {
        if (2 * p + 1 < hi) {
            const longlong2 kk = __ldg(two + p);
            atomicAdd(s_h + (unsigned)(kk.x >> 32), 1u);
            atomicAdd(s_h + (unsigned)(kk.y >> 32), 1u);
        } else {
            atomicAdd(s_h + (unsigned)(__ldg(keys + 2 * p) >> 32), 1u);
        }
    }
    __syncthreads();
    // the block's range in each tile it touches: its start in the tile
    unsigned* counts = st + COUNTS;
    unsigned* reserved = st + RESERVED + (size_t)blockIdx.x * nbins;
    for (int i = t; i < nbins; i += CS_THREADS) {
        const unsigned h = s_h[i];
        if (h) reserved[i] = atomicAdd(counts + i, h);
    }
    __threadfence();
    __syncthreads();
    unsigned* s_flag = s_w + (SCANNED + 1) * CS_WARPS;  // the last block's flag, largest tile
    if (t == 0) s_flag[0] = atomicAdd(st + DONE, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_flag[0]) return;

    // the last block: every count is in. Each thread takes a run of bins:
    // the offsets, the tiles in the order of their classes (each class in
    // tile order), the counters back to 0
    __threadfence();
    const int per = (nbins + CS_THREADS - 1) / CS_THREADS;
    const int b0 = t * per < nbins ? t * per : nbins;
    const int b1 = b0 + per < nbins ? b0 + per : nbins;
    unsigned a[SCANNED] = {}, total[SCANNED], top = 0;  // keys, then each class's tiles
    for (int i = b0; i < b1; ++i) {
        const unsigned c = __ldcg(counts + i);
        a[0] += c;
        const int cl = size_class(c);
#pragma unroll
        for (int j = 0; j < CLASSES; ++j) a[1 + j] += cl == j;
        top = c > top ? c : top;
    }
    if (t == 0) s_flag[1] = 0;
    scan_n(a, total, s_w);
    atomicMax(s_flag + 1, top);
    unsigned start[CLASSES];  // each class's first place in the order
    start[0] = 0;
#pragma unroll
    for (int j = 1; j < CLASSES; ++j) start[j] = start[j - 1] + total[j];
    unsigned* offsets = st + OFFSETS;
    unsigned* order = st + ORDER;
    for (int i = b0; i < b1; ++i) {
        const unsigned c = __ldcg(counts + i);
        offsets[i] = a[0];
        a[0] += c;
        const int cl = size_class(c);
        unsigned at = 0;
#pragma unroll
        for (int j = 0; j < CLASSES; ++j)
            if (cl == j) at = start[j] + a[1 + j]++;
        order[at] = (unsigned)i;
        counts[i] = 0;
    }
    __syncthreads();
    if (t == 0) {
        offsets[nbins] = total[0];
        st[N_BIG] = total[1];
        st[LARGEST] = s_flag[1];
        st[N_BLOCK] = total[1] + total[2];
        st[N_TILES] = nbins - total[CLASSES];
        st[TICKET_BLOCK] = st[TICKET_WARP] = 0;
        st[DONE] = 0;
    }
}

__global__ void __launch_bounds__(CS_THREADS) sort_instances_scatter(
    const long long* __restrict__ keys,  // (K,)
    int k, int chunk, int tile_bits,
    const unsigned* __restrict__ st,     // the state, as the count left it
    u64* __restrict__ bucket)            // (K,) out: v = (depth_bits << 32) | slot
{
    extern __shared__ __align__(16) unsigned char sort_smem[];
    unsigned* s_at = reinterpret_cast<unsigned*>(sort_smem);  // (nbins,) the next free place

    const int t = threadIdx.x, nbins = 1 << tile_bits;
    // a bin this block has no key of holds a stale start, never read
    const unsigned* reserved = st + RESERVED + (size_t)blockIdx.x * nbins;
    for (int i = t; i < nbins; i += CS_THREADS)
        s_at[i] = __ldg(st + OFFSETS + i) + __ldg(reserved + i);
    __syncthreads();
    const long long lo = (long long)blockIdx.x * chunk;
    const long long hi = lo + chunk < k ? lo + chunk : (long long)k;
    // the tile's range: its top SCATTER_PART_BITS bits (a grid of fewer
    // tiles in one range); each range reads the block's keys again (from
    // L2, mostly): held in registers through the ranges, in rounds, they ran
    // slower
    const int part_shift = tile_bits - SCATTER_PART_BITS;
    const int parts = part_shift >= 0 ? 1 << SCATTER_PART_BITS : 1;
    for (int part = 0; part < parts; ++part)
        for (long long i = lo + t; i < hi; i += CS_THREADS) {
            const long long key = __ldg(keys + i);
            const unsigned tile = (unsigned)(key >> 32);
            if (part_shift >= 0 && (int)(tile >> part_shift) != part) continue;
            const unsigned at = atomicAdd(s_at + tile, 1u);
            bucket[at] = ((u64)(key & 0x7fffffffll) << 32) | (u64)i;
        }
}

// A sorted value out: its key, and the gid of its slot.
__device__ __forceinline__ void put_key(long long* keys_out, int* gid_out, long long i, u64 v,
                                        unsigned tile, const int* gid)
{
    keys_out[i] = ((long long)tile << 32) | (long long)(v >> 32);
    gid_out[i] = __ldg(gid + (unsigned)(v & 0x7fffffffu));
}

// The count of A's among the first d values of the merge of sorted A (la
// values) and B (lb); the values are unique.
template <typename GetA, typename GetB>
__device__ __forceinline__ int merge_path(GetA a, GetB b, int la, int lb, int d)
{
    int lo = d - lb > 0 ? d - lb : 0, hi = d < la ? d : la;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a(mid) < b(d - 1 - mid)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// E values of the merge of the runs [a0, a0 + la) and [b0, b0 + lb) of
// shared memory from its d-th on (past its end: PAST)
template <int E>
__device__ __forceinline__ void merge_items(const u64* s_v, int a0, int la, int b0, int lb, int d,
                                            u64 (&v)[E])
{
    int i = merge_path([&](int x) { return s_v[pad(a0 + x)]; },
                       [&](int x) { return s_v[pad(b0 + x)]; }, la, lb, d);
    int j = d - i;
    u64 x = i < la ? s_v[pad(a0 + i)] : PAST, y = j < lb ? s_v[pad(b0 + j)] : PAST;
    // one load a step and no branch: the lanes of a warp take either side
#pragma unroll
    for (int q = 0; q < E; ++q) {
        const bool take_a = x < y;
        v[q] = take_a ? x : y;
        i += take_a;
        j += !take_a;
        const bool more = take_a ? i < la : j < lb;
        const u64 next = more ? s_v[pad(take_a ? a0 + i : b0 + j)] : PAST;
        x = take_a ? next : x;
        y = take_a ? y : next;
    }
}

// The thread's E values from place `base` on, back to shared memory.
template <int E>
__device__ __forceinline__ void put_items(u64* s_v, int base, int n, const u64 (&v)[E])
{
#pragma unroll
    for (int q = 0; q < E; ++q)
        if (base + q < n) s_v[pad(base + q)] = v[q];
}

// E values of a thread, sorted in registers by a bitonic network.
template <int E>
__device__ __forceinline__ void lane_sort(u64 (&v)[E])
{
#pragma unroll
    for (int k = 2; k <= E; k <<= 1)
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
            for (int q = 0; q < E; ++q)
                if ((q & j) == 0) {
                    const u64 a = v[q], b = v[q + j];
                    if ((a > b) == ((q & k) == 0)) {
                        v[q] = b;
                        v[q + j] = a;
                    }
                }
}

// The barrier of a sort's threads: the block's or the warp's.
template <bool BLOCK>
__device__ __forceinline__ void sort_barrier()
{
    if constexpr (BLOCK) __syncthreads();
    else __syncwarp();
}

// Sorts the n values in shared memory `s_v` in place, by the block's
// threads (BLOCK) or the warp's lanes, `me` the caller's index among them
// and n at most E times their number: E consecutive values a thread sorted
// in registers, then runs of E, 2 E, ... merged pairwise (merge path: a
// binary search for each thread's first output, then E steps). Every
// thread of the block (or lane of the warp) calls it; it ends at a barrier.
template <int E, bool BLOCK>
__device__ void merge_sort(u64* s_v, int n, int me)
{
    const int base = me * E;
    u64 v[E];
#pragma unroll
    for (int q = 0; q < E; ++q) v[q] = base + q < n ? s_v[pad(base + q)] : PAST;
    lane_sort(v);
    for (int w = E; w < n; w *= 2) {
        sort_barrier<BLOCK>();
        put_items(s_v, base, n, v);
        sort_barrier<BLOCK>();
        if (base < n) {
            const int s = base & ~(2 * w - 1);
            const int la = n - s < w ? n - s : w;
            const int lb = n - s - w < 0 ? 0 : (n - s - w < w ? n - s - w : w);
            merge_items(s_v, s, la, s + w, lb, base - s, v);
        }
    }
    sort_barrier<BLOCK>();
    put_items(s_v, base, n, v);
    sort_barrier<BLOCK>();
}

// A tile of n <= 32 E values sorted by one warp (the lanes' merge sort in
// the warp's shared memory `s_w`, no barrier but the warp's) and written
// out. The tile comes in and goes out through `s_w`, so that the warp
// reads and writes consecutive addresses.
template <int E>
__device__ void warp_sort(const u64* src, int n, long long* keys_out, int* gid_out,
                          const int* gid, unsigned tile, int lane, u64* s_w)
{
    // value 32 q + lane of the tile to each lane: every load in flight at once
    u64 v[E];
#pragma unroll
    for (int q = 0; q < E; ++q) v[q] = 32 * q + lane < n ? src[32 * q + lane] : PAST;
#pragma unroll
    for (int q = 0; q < E; ++q)
        if (32 * q + lane < n) s_w[pad(32 * q + lane)] = v[q];
    __syncwarp();
    merge_sort<E, false>(s_w, n, lane);
    for (int i = lane; i < n; i += 32) put_key(keys_out, gid_out, i, s_w[pad(i)], tile, gid);
    __syncwarp();
}

// A tile over CAP, by the whole block: each CAP run sorted, then runs
// merged pairwise through device memory. The bucket (p) and the output
// keys (q, holding values until the last level) are the two buffers; the
// last level reads p and writes the keys into q and the gids.
__device__ void sort_big_tile(u64* pv, long long* keys_q, int* gid_out, const int* gid, int n,
                              unsigned tile, u64* s_v, int* s_split)
{
    const int t = threadIdx.x;
    u64* qv = reinterpret_cast<u64*>(keys_q);
    int levels = 1;
    while (((long long)CAP << levels) < n) ++levels;
    {  // level 0, in place when the levels after it are odd
        u64* dv = levels % 2 ? pv : qv;
        for (int c = 0; c < n; c += CAP) {
            const int m = n - c < CAP ? n - c : CAP;
            for (int i = t; i < m; i += THREADS) s_v[pad(i)] = pv[c + i];
            __syncthreads();
            merge_sort<ITEMS, true>(s_v, m, t);
            for (int i = t; i < m; i += THREADS) dv[c + i] = s_v[pad(i)];
            __syncthreads();
        }
    }
    for (int l = 1; l <= levels; ++l) {
        const bool last = l == levels, to_q = (levels - l) % 2 == 0;
        const u64* sv = to_q ? pv : qv;
        u64* dv = to_q ? qv : pv;
        const long long w = (long long)CAP << (l - 1);
        for (long long s = 0; s < n; s += 2 * w) {
            const int la = (int)(n - s < w ? n - s : w);
            const int lb = (int)(n - s - w < 0 ? 0 : (n - s - w < w ? n - s - w : w));
            const int total = la + lb;
            const u64* av = sv + s;
            const u64* bv = sv + s + la;  // lb > 0 only where la == w
            const int chunks = (total + CAP - 1) / CAP;
            for (int c0 = 0; c0 < chunks; c0 += THREADS) {
                const int cnt = chunks - c0 < THREADS ? chunks - c0 : THREADS;
                __syncthreads();
                for (int e = t; e <= cnt; e += THREADS) {
                    const long long d = (long long)(c0 + e) * CAP;
                    s_split[e] = merge_path([&](int x) { return av[x]; },
                                            [&](int x) { return bv[x]; }, la, lb,
                                            (int)(d < total ? d : total));
                }
                __syncthreads();
                for (int c = 0; c < cnt; ++c) {
                    const long long d0 = (long long)(c0 + c) * CAP;
                    const int i0 = s_split[c], i1 = s_split[c + 1];
                    const int j0 = (int)(d0 - i0);
                    const int ma = i1 - i0;
                    const int m = (int)((d0 + CAP < total ? d0 + CAP : total) - d0);
                    const int mb = m - ma;
                    for (int i = t; i < ma; i += THREADS) s_v[pad(i)] = av[i0 + i];
                    for (int i = t; i < mb; i += THREADS) s_v[pad(ma + i)] = bv[j0 + i];
                    __syncthreads();
                    u64 v[ITEMS];
                    const int base = t * ITEMS;
                    if (base < m) merge_items(s_v, 0, ma, ma, mb, base, v);
                    __syncthreads();
                    if (base < m) put_items(s_v, base, m, v);
                    __syncthreads();
                    for (int i = t; i < m; i += THREADS) {
                        const long long o = s + d0 + i;
                        if (last) put_key(keys_q, gid_out, o, s_v[pad(i)], tile, gid);
                        else dv[o] = s_v[pad(i)];
                    }
                    __syncthreads();
                }
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS, 2) sort_instances_segment(
    u64* bucket,                         // (K,) the tiles' buckets (the big route's scratch)
    const int* __restrict__ gid,         // (K,) the input's gids
    long long* keys_out, int* gid_out,   // (K,)
    unsigned* st)
{
    extern __shared__ __align__(16) unsigned char sort_smem[];
    u64* s_v = reinterpret_cast<u64*>(sort_smem);                // (pad(CAP),)
    int* s_split = reinterpret_cast<int*>(s_v + pad(CAP));        // (THREADS + 1,)
    unsigned* s_ticket = reinterpret_cast<unsigned*>(sort_smem + SEG_SMEM - 16);

    const int t = threadIdx.x;
    const unsigned wide = st[N_BLOCK], busy = st[N_TILES];
    // the tiles over WARP_CAP, the largest first: a block each, the next
    // one free
    for (;;) {
        if (t == 0) *s_ticket = atomicAdd(st + TICKET_BLOCK, 1u);
        __syncthreads();
        const unsigned b = *s_ticket;
        __syncthreads();
        if (b >= wide) break;
        const unsigned tile = st[ORDER + b];
        const unsigned off = st[OFFSETS + tile];
        const int n = (int)(st[OFFSETS + tile + 1] - off);
        if (n > CAP) {
            sort_big_tile(bucket + off, keys_out + off, gid_out + off, gid, n, tile, s_v,
                          s_split);
            continue;
        }
        for (int i = t; i < n; i += THREADS) s_v[pad(i)] = bucket[off + i];
        __syncthreads();
        merge_sort<ITEMS, true>(s_v, n, t);
        for (int i = t; i < n; i += THREADS)
            put_key(keys_out + off, gid_out + off, i, s_v[pad(i)], tile, gid);
        __syncthreads();
    }
    // the others, the largest first: a warp each, the next one free; E
    // values a lane for a tile of 16 E + 1 ... 32 E keys (of up to 128: E = 4)
    const int lane = t & 31;
    u64* s_w = reinterpret_cast<u64*>(sort_smem) + (t >> 5) * pad(WARP_CAP);
    for (;;) {
        unsigned b = 0;
        if (lane == 0) b = atomicAdd(st + TICKET_WARP, 1u);
        b = wide + __shfl_sync(0xffffffffu, b, 0);
        if (b >= busy) break;
        const unsigned tile = st[ORDER + b];
        const unsigned off = st[OFFSETS + tile];
        const int n = (int)(st[OFFSETS + tile + 1] - off);
        const u64* src = bucket + off;
        long long* ko = keys_out + off;
        int* go = gid_out + off;
        if (n <= 32 * 4) warp_sort<4>(src, n, ko, go, gid, tile, lane, s_w);
        else if (n <= 32 * 8) warp_sort<8>(src, n, ko, go, gid, tile, lane, s_w);
        else if (n <= 32 * 16) warp_sort<16>(src, n, ko, go, gid, tile, lane, s_w);
        else warp_sort<WARP_ITEMS>(src, n, ko, go, gid, tile, lane, s_w);
    }
}

struct Layout {
    long long words;  // int64 words of the state
    int tile_bits, chunk, blocks, seg_blocks;
};

int bits_of(int key_bits) { return key_bits > 31 ? key_bits - 31 : 0; }
size_t count_smem(int nbins) { return (size_t)nbins * 4 + HEAD_SMEM; }

constexpr int KERNELS = 3;  // count, scatter, segment

// Each kernel's shared memory at a grid of 2^tile_bits bins.
void smem_of(int tile_bits, size_t (&smem)[KERNELS])
{
    const int nbins = 1 << tile_bits;
    smem[0] = count_smem(nbins);
    smem[1] = (size_t)nbins * 4;
    smem[2] = SEG_SMEM;
}

// The device's SMs and each kernel's blocks an SM at a grid of 2^b bins,
// asked once per device and b (the shared-memory limits set then too).
constexpr int MAX_DEVICES = 64;
struct Shapes { int sms, occ[MAX_TILE_BITS + 1][KERNELS]; };
Shapes g_shapes[MAX_DEVICES];

cudaError_t shapes_of(int tile_bits, int* sms, int (&occ)[KERNELS])
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidValue;
    Shapes& sh = g_shapes[dev];
    const void* kernels[KERNELS] = {(const void*)sort_instances_count,
                                    (const void*)sort_instances_scatter,
                                    (const void*)sort_instances_segment};
    const int threads[KERNELS] = {CS_THREADS, CS_THREADS, THREADS};
    if (sh.sms == 0) {
        size_t most[KERNELS];
        smem_of(MAX_TILE_BITS, most);
        for (int i = 0; i < KERNELS; ++i)
            if ((err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)most[i])) != cudaSuccess)
                return err;
        if ((err = cudaDeviceGetAttribute(&sh.sms, cudaDevAttrMultiProcessorCount, dev))
            != cudaSuccess)
            return err;
    }
    int (&o)[KERNELS] = sh.occ[tile_bits];
    if (o[0] == 0) {
        size_t smem[KERNELS];
        smem_of(tile_bits, smem);
        for (int i = 0; i < KERNELS; ++i) {
            int n = 0;
            if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[i], threads[i],
                                                                     smem[i])) != cudaSuccess)
                return err;
            o[i] = n > 1 ? n : 1;
        }
    }
    *sms = sh.sms;
    for (int i = 0; i < KERNELS; ++i) occ[i] = o[i];
    return cudaSuccess;
}

// The launch shapes for k keys of key_bits: count and scatter blocks by
// the card's SMs and their occupancy (at most CS_PER_SM an SM), each block
// at least CHUNK_MIN slots (an even number); the segment kernel
// persistent over the tiles.
cudaError_t layout_of(long long k, int key_bits, Layout* out)
{
    const int tile_bits = bits_of(key_bits), nbins = 1 << tile_bits;
    int sms = 0, occ[KERNELS];
    const cudaError_t err = shapes_of(tile_bits, &sms, occ);
    if (err != cudaSuccess) return err;
    int occ_cs = occ[0] < occ[1] ? occ[0] : occ[1];
    occ_cs = occ_cs < CS_PER_SM ? occ_cs : CS_PER_SM;
    long long blocks = (k + CHUNK_MIN - 1) / CHUNK_MIN;
    blocks = blocks < (long long)sms * occ_cs ? blocks : (long long)sms * occ_cs;
    blocks = blocks > 1 ? blocks : 1;
    long long chunk = (k + blocks - 1) / blocks;
    chunk += chunk % 2;
    out->tile_bits = tile_bits;
    out->chunk = (int)chunk;
    out->blocks = (int)((k + chunk - 1) / chunk > 0 ? (k + chunk - 1) / chunk : 1);
    const long long seg = (long long)sms * occ[2];
    out->seg_blocks = (int)(nbins < seg ? nbins : seg);
    out->words = (RESERVED + (long long)out->blocks * nbins + 1) / 2;
    return cudaSuccess;
}

}  // namespace

// out[0] the state's int64 words for `k` keys of `key_bits`, out[1] the
// tile bins, out[2] CAP, out[3] the count and scatter blocks,
// out[4] the segment kernel's blocks, out[5] WARP_CAP
extern "C" int gs_sort_layout(long long k, int key_bits, long long* out)
{
    if (k < 0 || k >= (1ll << 31) || key_bits < 1 || key_bits > MAX_KEY_BITS)
        return (int)cudaErrorInvalidValue;
    Layout l;
    const cudaError_t err = layout_of(k, key_bits, &l);
    if (err != cudaSuccess) return (int)err;
    out[0] = l.words;
    out[1] = 1ll << l.tile_bits;
    out[2] = CAP;
    out[3] = l.blocks;
    out[4] = l.seg_blocks;
    out[5] = WARP_CAP;
    return 0;
}

// Sorts `k` (key, gid) pairs by key, stably: keys_out and gid_out get the
// result; `bucket` (k 64-bit words) holds the tiles' buckets. Precondition: bit 31 of every key
// is 0 and the key with it taken out is under 2^key_bits (K1''s keys of
// slots with depth > 0.2). `state` is the device's buffer of at least
// gs_sort_layout's words, zeroed once when allocated.
extern "C" int gs_sort_instances(
    const void* keys, const void* gid, long long k, int key_bits, void* bucket, void* keys_out,
    void* gid_out, void* state, long long words, void* stream)
{
    if (k <= 0 || k >= (1ll << 31) || key_bits < 1 || key_bits > MAX_KEY_BITS)
        return (int)cudaErrorInvalidValue;
    Layout l;
    cudaError_t err = layout_of(k, key_bits, &l);
    if (err != cudaSuccess) return (int)err;
    if (words < l.words) return (int)cudaErrorInvalidValue;
    size_t smem[KERNELS];
    smem_of(l.tile_bits, smem);
    const cudaStream_t s = (cudaStream_t)stream;
    unsigned* st = (unsigned*)state;
    sort_instances_count<<<l.blocks, CS_THREADS, smem[0], s>>>(
        (const long long*)keys, (int)k, l.chunk, l.tile_bits, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sort_instances_scatter<<<l.blocks, CS_THREADS, smem[1], s>>>(
        (const long long*)keys, (int)k, l.chunk, l.tile_bits, st, (u64*)bucket);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sort_instances_segment<<<l.seg_blocks, THREADS, smem[2], s>>>(
        (u64*)bucket, (const int*)gid, (long long*)keys_out, (int*)gid_out, st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return 0;
}
