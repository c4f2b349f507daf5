// Kernel K1': tile binning for the sorted blend, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_expand_kernel` of gsplat_tpu/ops/binning.py
// (:485, launched by `_expand_instances` from `pack_bins`). On the TPU that
// kernel run-length-decodes instance slots with a one-hot window matmul,
// because the TPU has no cheap scatter; it emits sort keys and the ten blend
// attribute columns, which then ride one wide `lax.sort` as payload.
//
// On the GPU a store at a prefix-sum offset is cheap, so the work splits
// around the sort (`torch.sort(stable=True)` in the wrapper) into two kernels:
//
//   gs_expand_instances  a block of 256 threads owns 256 consecutive
//                        gaussians, whose instance slots are one contiguous
//                        range [cum_excl[g0], cum_excl[g_last] + count_last)
//                        (the CUDA reference's duplicateWithKeys, load
//                        balanced). The block stages its gaussians' offsets
//                        and, for live ones, rects and depth bits (under
//                        tight_cull, the row runs of its trimmed ones, read
//                        as consecutive int4 over the block's rows) in
//                        shared memory, then walks its range 256
//                        slots at a time: each thread finds its slot's owner
//                        by binary search over the staged offsets and decodes
//                        the tile from the rect (binning.py:548-554) or from
//                        the row runs (RUN_HMAX = 8, binning.py:556-574).
//                        Key per slot: (tile << 32) | depth_bits; payload: the
//                        gid. Slots are in gid order, so a stable sort gives
//                        the JAX order (tile, depth bits, gid). The same
//                        launch writes one 48-byte packet row per live
//                        gaussian (count > 0): [mx, my, -a/2, -b, -c/2, op,
//                        r, g, b, invz, 0, 0], invz = 1/max(depth, 0.2),
//                        unrounded, staged in shared memory and stored as
//                        consecutive float4 over the block's rows. Dead rows
//                        are never written.
//   gs_pack_instances    one thread per sorted slot reads its gaussian's
//                        packet row (three float4 loads: two 32-byte sectors)
//                        into the (16, K) float32 instance table and writes
//                        the tile boundaries. `mode` is the packet mode:
//                        0 float32 (every row exact); 1 hybrid (the training
//                        default, binning.py:737-795), the folded conic,
//                        opacity and rgb rows 2-8 rounded to bf16 (nearest
//                        even) after the fold, as the JAX package's bf16 pair
//                        packing leaves them, mean2d and invz exact;
//                        2 bfloat16 (binning.py:743-746), all ten rows
//                        rounded, mean2d and invz (computed in float32 first)
//                        included. Rounded values are stored as float32.
//
// Bound on the card: bytes. Both kernels do a few integer operations per
// byte they move. Expand: each store instruction of a warp writes 32
// consecutive keys and gids (the slots of one step of the walk) or 512
// consecutive bytes of packet rows, and each load of the run tables reads
// 512 consecutive bytes less the rows that need none. Pack: the sorted
// keys and the permutation are read coalesced, then two dependent random
// reads per instance (the slot's gid, 4 bytes, and its gaussian's packet
// row, two sectors, through the read-only path), where the five screen
// arrays cost six or seven sectors; the 16-row table stores are coalesced.
//
// Every value is copied or computed with exact integer or IEEE float32
// operations (built with -fmad=false), and rounded to bf16 the one way the
// JAX package rounds, so the result equals the JAX package's bit for bit.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int RUN_HMAX = 8;
constexpr int N_ROWS = 16;
constexpr int EXPAND_THREADS = 256;  // gaussians per block = slots per step

__global__ void __launch_bounds__(EXPAND_THREADS) expand_instances_kernel(
    const int* __restrict__ rect,          // (N, 4) rmin_x, rmin_y, rect_w, tiles_post, 16-B rows
    const long long* __restrict__ cum_excl,  // (N,)
    const unsigned char* __restrict__ trimmed,  // (N,)
    const int* __restrict__ t_lo,          // (N, 8) first tile column per row, 32-B rows
    const int* __restrict__ cum_run,       // (N, 8) exclusive run-length prefix, 32-B rows
    const float* __restrict__ mean2d,      // (N, 2)
    const float* __restrict__ conic,       // (N, 3)
    const float* __restrict__ opacity,     // (N,)
    const float* __restrict__ rgb,         // (N, 3)
    const float* __restrict__ depth,       // (N,)
    int n, int grid_x, int tight_cull,
    long long* __restrict__ keys,          // (K,)
    int* __restrict__ gids,                // (K,)
    float4* __restrict__ packets)          // (N, 12) as 3 float4 per row
{
    // offsets of the block's gaussians in its slot range; rows past N hold
    // INT_MAX so the search never lands on them
    __shared__ int s_off[EXPAND_THREADS];
    __shared__ int s_rx[EXPAND_THREADS], s_ry[EXPAND_THREADS], s_rw[EXPAND_THREADS];
    __shared__ unsigned int s_dbits[EXPAND_THREADS];
    __shared__ unsigned char s_live[EXPAND_THREADS], s_trim[EXPAND_THREADS];
    // first the block's packet rows (3 float4 each, 12 KB), then its run
    // tables (t_lo, cum_run: 2 x 8 KB)
    __shared__ __align__(16) int s_runs[2 * EXPAND_THREADS * RUN_HMAX];
    __shared__ int s_total;
    float4* s_pk = reinterpret_cast<float4*>(s_runs);
    int* s_tlo = s_runs;
    int* s_crun = s_runs + EXPAND_THREADS * RUN_HMAX;

    const int t = threadIdx.x;
    const int g0 = blockIdx.x * EXPAND_THREADS;
    const int g = g0 + t;
    const int rows = min(EXPAND_THREADS, n - g0);
    const long long lo = cum_excl[g0];

    // 1. each thread stages its gaussian: one 16-byte load of the rect and
    // the offset; the rest only for a live row (dead rows, such as the
    // padding of a train state's capacity, cost their count and offset)
    s_live[t] = 0;
    s_trim[t] = 0;
    if (t < rows) {
        const int4 rc = __ldg(reinterpret_cast<const int4*>(rect) + g);
        const int count = rc.w;
        const int off = (int)(cum_excl[g] - lo);
        s_off[t] = off;
        if (t == rows - 1) s_total = off + count;
        if (count > 0) {
            const float d = depth[g];
            s_live[t] = 1;
            s_rx[t] = rc.x;
            s_ry[t] = rc.y;
            s_rw[t] = rc.z > 1 ? rc.z : 1;
            // valid rows have depth > 0.2: positive float bits, monotone as integers
            s_dbits[t] = (unsigned int)__float_as_int(d);
            s_trim[t] = tight_cull && trimmed[g];
            s_pk[3 * t + 0] = make_float4(mean2d[2 * g + 0], mean2d[2 * g + 1],
                                          -0.5f * conic[3 * g + 0], -conic[3 * g + 1]);
            s_pk[3 * t + 1] = make_float4(-0.5f * conic[3 * g + 2], opacity[g],
                                          rgb[3 * g + 0], rgb[3 * g + 1]);
            s_pk[3 * t + 2] = make_float4(rgb[3 * g + 2], 1.0f / fmaxf(d, 0.2f), 0.0f, 0.0f);
        }
    } else {
        s_off[t] = INT_MAX;
    }
    __syncthreads();

    // 2. the live rows' packets out, then the trimmed rows' run tables in,
    // each as consecutive float4 / int4 over the block's rows (coalesced;
    // the rows a predicate skips cost nothing)
    float4* pk = packets + 3 * (size_t)g0;
    for (int q = t; q < 3 * rows; q += EXPAND_THREADS)
        if (s_live[q / 3]) pk[q] = s_pk[q];
    __syncthreads();
    if (tight_cull) {
        const int4* tl = reinterpret_cast<const int4*>(t_lo) + 2 * (size_t)g0;
        const int4* cr = reinterpret_cast<const int4*>(cum_run) + 2 * (size_t)g0;
        for (int q = t; q < 2 * rows; q += EXPAND_THREADS) {
            if (s_trim[q >> 1]) {
                reinterpret_cast<int4*>(s_tlo)[q] = __ldg(tl + q);
                reinterpret_cast<int4*>(s_crun)[q] = __ldg(cr + q);
            }
        }
    }
    __syncthreads();

    const int total = s_total;
    for (int s = t; s < total; s += EXPAND_THREADS) {
        // owner: the last gaussian whose offset is <= s. Zero-count
        // gaussians share their offset with the next one, so the last of
        // equal offsets is the one with slots
        int j = 0;
#pragma unroll
        for (int step = EXPAND_THREADS / 2; step > 0; step >>= 1)
            if (s_off[j + step] <= s) j += step;
        const int local = s - s_off[j];
        int tx, ty;
        if (s_trim[j]) {
            // run-trimmed decode: row r holds the slots from cum_run[r] on;
            // empty rows share their prefix with the next row, so r is the
            // last row whose prefix `local` has reached
            const int* cr = s_crun + RUN_HMAX * j;
            int r = 0;
#pragma unroll
            for (int q = 1; q < RUN_HMAX; ++q) r += local >= cr[q];
            tx = s_tlo[RUN_HMAX * j + r] + (local - cr[r]);
            ty = s_ry[j] + r;
        } else {
            // rect decode, slot by slot as in binning.py:548-554
            const int rw = s_rw[j];
            const int ly = local / rw;
            tx = s_rx[j] + (local - ly * rw);
            ty = s_ry[j] + ly;
        }
        const long long tile = (long long)ty * grid_x + tx;
        keys[lo + s] = (tile << 32) | (long long)s_dbits[j];
        gids[lo + s] = g0 + j;
    }
}

__global__ void pack_instances_kernel(
    const long long* __restrict__ keys_sorted,  // (K,)
    const long long* __restrict__ perm,         // (K,) sort permutation
    const int* __restrict__ gids,               // (K,) unsorted slot gids
    const float4* __restrict__ packets,         // (N, 12) as 3 float4 per row
    long long k, int num_tiles, int mode,
    float* __restrict__ inst_t,                 // (16, K)
    int* __restrict__ gauss_id,                 // (K,)
    int* __restrict__ tile_id,                  // (K,)
    int* __restrict__ bounds)                   // (T+1,)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i > k) return;

    // tile boundaries: bounds[t] = first sorted slot with tile >= t. Thread i
    // owns every t in (tile[i-1], tile[i]], with tile[-1] = -1 and
    // tile[K] = num_tiles, so each entry is written exactly once and empty
    // tiles get start == end, as a searchsorted gives.
    const int prev = (i == 0) ? -1 : (int)(keys_sorted[i - 1] >> 32);
    const int cur = (i == k) ? num_tiles : (int)(keys_sorted[i] >> 32);
    for (int t = prev + 1; t <= cur; ++t) bounds[t] = (int)i;
    if (i == k) return;

    const int g = gids[perm[i]];
    gauss_id[i] = g;
    tile_id[i] = cur;
    const float4* row = packets + 3 * (size_t)g;
    const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
    const float vals[10] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y};
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const bool rounded = mode == 2 || (mode == 1 && r >= 2 && r <= 8);
        inst_t[r * k + i] = rounded ? gs::round_bf16(vals[r]) : vals[r];
    }
#pragma unroll
    for (int r = 10; r < N_ROWS; ++r) inst_t[r * k + i] = 0.0f;
}

}  // namespace

extern "C" int gs_expand_instances(
    const void* rect, const void* cum_excl, const void* trimmed, const void* t_lo,
    const void* cum_run, const void* mean2d, const void* conic, const void* opacity,
    const void* rgb, const void* depth, int n, int grid_x, int tight_cull,
    void* keys, void* gids, void* packets, void* stream)
{
    const int blocks = (n + EXPAND_THREADS - 1) / EXPAND_THREADS;
    expand_instances_kernel<<<blocks, EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)rect, (const long long*)cum_excl, (const unsigned char*)trimmed,
        (const int*)t_lo, (const int*)cum_run, (const float*)mean2d, (const float*)conic,
        (const float*)opacity, (const float*)rgb, (const float*)depth, n, grid_x,
        tight_cull, (long long*)keys, (int*)gids, (float4*)packets);
    return (int)cudaGetLastError();
}

extern "C" int gs_pack_instances(
    const void* keys_sorted, const void* perm, const void* gids, const void* packets,
    long long k, int num_tiles, int mode, void* inst_t, void* gauss_id,
    void* tile_id, void* bounds, void* stream)
{
    const int threads = 256;
    const long long blocks = (k + 1 + threads - 1) / threads;  // K + 1 threads
    pack_instances_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys_sorted, (const long long*)perm, (const int*)gids,
        (const float4*)packets, k, num_tiles, mode, (float*)inst_t,
        (int*)gauss_id, (int*)tile_id, (int*)bounds);
    return (int)cudaGetLastError();
}
