// Kernels Bt' and K1': tile binning for the sorted blend, on Hopper (sm_90a).
//
// Bt', `gs_emission_tables`, replaces no Pallas kernel: in the JAX package
// the tight-cull row runs (`compute_row_runs`, gsplat_tpu/ops/binning.py:171)
// and the instance prefix sum (:673-675) are XLA fusions inside the jitted
// frame. The port ran them as ~100 eager torch launches and a host read of
// the total; here they are one launch. A thread takes four gaussians (a
// block 1,024, each warp access 32 consecutive rows), reads each one's
// screen columns once (rect_min, rect_max, conic, mean2d, cull_qmax,
// tiles_touched: 44 bytes), runs its eight rect rows in registers in the
// operation order of the plain twin (`_emission_tables_torch`, torch's CUDA
// ops one by one: `torch.clamp`, `maximum` and `minimum` with their NaN
// rules written out, `/ tile` as torch's multiply by the reciprocal, float
// to int32 by `static_cast`), and writes rect [rmin_x, rmin_y, max(rect_w,
// 1), tiles_post], the trimmed flag, t_lo and cum_run (8 int32 each) and
// cum_excl, the exclusive int64 prefix sum of tiles_post (89 bytes).
//
// The prefix sum is a single-pass scan with decoupled look-back (Merrill
// and Garland), a block of 1,024 rows a scan block: blocks take their place
// in the order by an atomic ticket, each publishes its aggregate, then
// finds its exclusive prefix by walking back over its predecessors'
// published aggregates and inclusive prefixes, a warp 32 blocks at a time,
// and publishes its own inclusive prefix; the last block writes the total
// K. A block's status is a flag word, (launch number << 2) | state, beside
// two int64 value slots, so the sums keep torch's int64 range and nothing
// is zeroed between launches: a flag from an earlier launch reads as not
// yet published. The look-back's chain costs time per block: on an H100
// 80GB HBM3 (700 W) and the 1M-row flagship frame, blocks of 256 rows took
// 0.110 ms against 0.062 without it, blocks of 1,024 0.083 against 0.072
// (`scripts/tables_ablate.py`).
//
// Bound on the card: bytes (133 a row; a few hundred float operations).
//
// K1' replaces the Pallas kernel `_expand_kernel` of gsplat_tpu/ops/binning.py
// (:485, launched by `_expand_instances` from `pack_bins`). On the TPU that
// kernel run-length-decodes instance slots with a one-hot window matmul,
// because the TPU has no cheap scatter; it emits sort keys and the ten blend
// attribute columns, which then ride one wide `lax.sort` as payload.
//
// On the GPU a store at a prefix-sum offset is cheap, so the work splits
// around the sort (kernel St', `csrc/sort.cu`, which carries the gid as its
// payload) into two kernels:
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
//   gs_pack_instances    one thread per sorted slot reads its sorted gid
//                        and its gaussian's packet row (three float4 loads:
//                        two 32-byte sectors) into the (16, K) float32
//                        instance table and writes the tile boundaries. `mode` is the packet mode:
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
// keys and gids are read coalesced, then one random read per instance (its
// gaussian's packet row, two sectors, through the read-only path), where
// the five screen arrays cost six or seven sectors; the 16-row table
// stores are coalesced.
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
constexpr int TABLE_THREADS = 256;   // Bt': threads per block
constexpr int TABLE_WARPS = TABLE_THREADS / 32;
constexpr int TABLE_ROWS = 4;        // Bt': gaussians per thread
constexpr int TABLE_TILE = TABLE_THREADS * TABLE_ROWS;  // gaussians per block = per scan block
constexpr int TABLE_PARTS = TABLE_ROWS * TABLE_WARPS;  // (row group, warp) sums a block
static_assert(TABLE_PARTS <= 32, "one warp scans the block's warp sums");
// the tight cull's outward padding of the run ends (binning.py _RUN_PAD_*)
constexpr float RUN_PAD_REL = 1.000244140625f;  // 1 + 2^-12
constexpr float RUN_PAD_ABS = 0.00390625f;      // 2^-8 pixels
// a scan block's state, the low two bits of its flag word
constexpr unsigned long long SCAN_AGGREGATE = 1, SCAN_PREFIX = 2;

// torch's CUDA float ops where a NaN must come out as torch's does (fmaxf
// and fminf alone return the other operand): `torch.maximum` / `minimum`
// give the first NaN operand; `torch.clamp` with tensor bounds the value,
// else the lower, else the upper bound if NaN, else min(max(v, lo), hi);
// `clamp(min=scalar)` the value if NaN
__device__ __forceinline__ float t_maximum(float a, float b)
{
    return a != a ? a : b != b ? b : fmaxf(a, b);
}

__device__ __forceinline__ float t_minimum(float a, float b)
{
    return a != a ? a : b != b ? b : fminf(a, b);
}

__device__ __forceinline__ float t_clamp(float v, float lo, float hi)
{
    return v != v ? v : lo != lo ? lo : hi != hi ? hi : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo)
{
    return v != v ? v : fmaxf(v, lo);
}

// one end of a rect row's run (binning.py `endpoint`): the ellipse's x at
// the band's dy nearest the peak's, padded outward; `sign` is +1 for the
// right end and -1 for the left, multiplied in as torch multiplies it
__device__ __forceinline__ float run_end(float dy_pk, float dy0, float dy1, float aq2,
                                         float det_s, float nb, float mx, float a_s, float sign)
{
    const float dye = t_clamp(dy_pk, dy0, dy1);
    const float disc = aq2 - det_s * dye * dye;
    const float root = sqrtf(t_clamp_min(disc, 0.0f)) * RUN_PAD_REL;
    const float x = mx + (nb * dye + root * sign) / a_s;
    return x + sign * RUN_PAD_ABS;
}

// One gaussian's tight-cull row runs (binning.py `compute_row_runs`): the
// first tile column and the exclusive run-length prefix of each of the
// eight rect rows (integer-valued floats cast to int32), the trimmed flag,
// and tiles_post as the return value. Rows that are not trimmed, dead ones
// included, get the twin's values from its substitutes a = c = det = qmax
// = 1. `inv_tile` is 1 / tile in float32: torch divides a tensor by a
// Python number as a multiply by its reciprocal.
__device__ __forceinline__ int row_runs(
    int rmin_xi, int rmin_yi, int rmax_xi, int rmax_yi, int touched, float a, float b, float c,
    float mx, float my, float qmax, float ftile, float tile_m1, float inv_tile, bool& trim,
    int (&t_lo)[RUN_HMAX], int (&cum_run)[RUN_HMAX])
{
    const int rect_h = (int)((unsigned)rmax_yi - (unsigned)rmin_yi);
    const float det = a * c - b * b;
    trim = touched > 0 && a > 0.0f && c > 0.0f && det > 0.0f && rect_h <= RUN_HMAX && qmax > 0.0f;
    const float a_s = trim ? a : 1.0f, c_s = trim ? c : 1.0f;
    const float det_s = trim ? det : 1.0f, q_s = trim ? qmax : 1.0f;
    const float rx = sqrtf(2.0f * q_s * c_s / det_s);
    const float bc = b / c_s;
    const float dy_pk_hi = -bc * rx;  // dy of the ellipse's rightmost point
    const float dy_pk_lo = bc * rx;
    const float aq2 = 2.0f * (a_s * q_s);
    const float nb = -b;
    const float rmin_x = (float)rmin_xi, rmin_y = (float)rmin_yi;
    const float rmax_x1 = (float)(int)((unsigned)rmax_xi - 1u);
    const float h = (float)rect_h;
    float cum_inc = 0.0f;
#pragma unroll
    for (int r = 0; r < RUN_HMAX; ++r) {
        const float dy0 = (rmin_y + (float)r) * ftile - my;
        const float dy1 = dy0 + tile_m1;
        const float dyc = t_clamp(0.0f, dy0, dy1);
        const float s_c = aq2 - det_s * dyc * dyc;
        const bool row_live = s_c >= 0.0f && (float)r < h;
        const float x_hi = run_end(dy_pk_hi, dy0, dy1, aq2, det_s, nb, mx, a_s, 1.0f);
        const float x_lo = run_end(dy_pk_lo, dy0, dy1, aq2, det_s, nb, mx, a_s, -1.0f);
        const float lo = t_maximum(rmin_x, ceilf((x_lo - tile_m1) * inv_tile));
        const float hi = t_minimum(rmax_x1, floorf(x_hi * inv_tile));
        const float run = row_live ? t_clamp_min(hi - lo + 1.0f, 0.0f) : 0.0f;
        t_lo[r] = static_cast<int>(row_live && run > 0.0f ? lo : rmin_x);
        // the twin's explicit column adds: the inclusive prefix, less the row
        cum_inc = r == 0 ? run : cum_inc + run;
        cum_run[r] = static_cast<int>(cum_inc - run);
    }
    return static_cast<int>(trim ? cum_inc : (float)touched);
}

// a scan block's value, then its flag: a reader that sees the flag of this
// launch reads the value written before it (volatile: past the L1)
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long* value,
                                        int blk, unsigned long long v, unsigned long long word)
{
    *(volatile unsigned long long*)(value + blk) = v;
    __threadfence();
    *(volatile unsigned long long*)(flag + blk) = word;
}

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p)
{
    return *(const volatile unsigned long long*)p;
}

__global__ void __launch_bounds__(TABLE_THREADS) emission_tables_kernel(
    const int* __restrict__ rect_min,       // (N, 2)
    const int* __restrict__ rect_max,       // (N, 2)
    const float* __restrict__ conic,        // (N, 3)
    const float* __restrict__ mean2d,       // (N, 2)
    const float* __restrict__ cull_qmax,    // (N,)
    const int* __restrict__ tiles_touched,  // (N,)
    int n, int tile, int tight_cull,
    int4* __restrict__ rect,                // (N, 4) rmin_x, rmin_y, max(rect_w, 1), tiles_post
    unsigned char* __restrict__ trimmed,    // (N,)
    int4* __restrict__ t_lo,                // (N, 8)
    int4* __restrict__ cum_run,             // (N, 8)
    long long* __restrict__ cum_excl,       // (N,)
    long long* __restrict__ total,          // () K
    unsigned long long* flag,               // (blocks,) (epoch << 2) | state
    unsigned long long* agg,                // (blocks,) each block's sum of tiles_post
    unsigned long long* incl,               // (blocks,) the sum through each block
    unsigned int* ticket,                   // () 0 before and after a launch
    unsigned long long epoch)               // this launch's number, > 0
{
    // each (row group, warp)'s sum of tiles_post, then their exclusive scan
    __shared__ unsigned long long s_part[TABLE_PARTS];
    __shared__ unsigned long long s_excl;  // the block's exclusive prefix
    __shared__ int s_block;                // the block's place in the order

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t == 0) s_block = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int blk = s_block;
    // the last ticket: every other block holds its own, the counter is free
    if (t == 0 && blk == (int)gridDim.x - 1) *ticket = 0u;

    // 1. the block's TABLE_TILE gaussians in TABLE_ROWS groups of
    // TABLE_THREADS consecutive ones (each warp store covers 32 rows): each
    // thread's tables in registers, out; tiles_post kept with its warp's
    // inclusive scan (int64, wrapping as torch's cumsum does)
    const int g0 = blk * TABLE_TILE + t;
    unsigned long long own[TABLE_ROWS], in_warp[TABLE_ROWS];
#pragma unroll
    for (int k = 0; k < TABLE_ROWS; ++k) {
        const int g = g0 + k * TABLE_THREADS;
        int tp = 0;
        if (g < n) {
            const int rx0 = rect_min[2 * g], ry0 = rect_min[2 * g + 1];
            const int rx1 = rect_max[2 * g], ry1 = rect_max[2 * g + 1];
            const int touched = tiles_touched[g];
            int lo[RUN_HMAX], cr[RUN_HMAX];
            bool trim = false;
            if (tight_cull) {
                tp = row_runs(rx0, ry0, rx1, ry1, touched, conic[3 * g], conic[3 * g + 1],
                              conic[3 * g + 2], mean2d[2 * g], mean2d[2 * g + 1], cull_qmax[g],
                              (float)tile, (float)(tile - 1), 1.0f / (float)tile, trim, lo, cr);
            } else {
                tp = touched;
#pragma unroll
                for (int r = 0; r < RUN_HMAX; ++r) lo[r] = cr[r] = 0;
            }
            const int w = (int)((unsigned)rx1 - (unsigned)rx0);
            rect[g] = make_int4(rx0, ry0, w > 1 ? w : 1, tp);
            trimmed[g] = trim;
            t_lo[2 * g] = make_int4(lo[0], lo[1], lo[2], lo[3]);
            t_lo[2 * g + 1] = make_int4(lo[4], lo[5], lo[6], lo[7]);
            cum_run[2 * g] = make_int4(cr[0], cr[1], cr[2], cr[3]);
            cum_run[2 * g + 1] = make_int4(cr[4], cr[5], cr[6], cr[7]);
        }
        own[k] = (unsigned long long)(long long)tp;
        unsigned long long v = own[k];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long u = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v += u;
        }
        in_warp[k] = v;
        if (lane == 31) s_part[k * TABLE_WARPS + warp] = v;
    }
    __syncthreads();

    // 2. warp 0: the exclusive scan of the 32 (group, warp) sums, in row
    // order; then the block's exclusive prefix: its aggregate out, and a walk
    // back 32 blocks at a time, summing aggregates up to the nearest block
    // that has published its inclusive prefix (block 0's is its aggregate)
    if (warp == 0) {
        const unsigned long long part = lane < TABLE_PARTS ? s_part[lane] : 0ull;
        unsigned long long v = part;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long u = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v += u;
        }
        if (lane < TABLE_PARTS) s_part[lane] = v - part;
        const unsigned long long block_sum = __shfl_sync(0xffffffffu, v, 31);
        const unsigned long long tag = epoch << 2;
        unsigned long long excl = 0;
        if (blk == 0) {
            if (lane == 0) publish(flag, incl, 0, block_sum, tag | SCAN_PREFIX);
        } else {
            if (lane == 0) publish(flag, agg, blk, block_sum, tag | SCAN_AGGREGATE);
            for (int end = blk - 1;; end -= 32) {
                const int p = end - lane;  // lane 0 the nearest
                unsigned long long state = SCAN_PREFIX, val = 0;
                if (p >= 0) {
                    unsigned long long f;
                    while (((f = load_volatile(flag + p)) >> 2) != epoch) __nanosleep(32);
                    __threadfence();
                    state = f & 3ull;
                    val = load_volatile((state == SCAN_PREFIX ? incl : agg) + p);
                }
                const unsigned prefix = __ballot_sync(0xffffffffu, state == SCAN_PREFIX);
                const int stop = prefix ? __ffs(prefix) - 1 : 31;
                unsigned long long sum = lane <= stop ? val : 0ull;
#pragma unroll
                for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
                excl += sum;
                if (prefix) break;
            }
            if (lane == 0) publish(flag, incl, blk, excl + block_sum, tag | SCAN_PREFIX);
        }
        if (lane == 0) {
            s_excl = excl;
            if (blk == (int)gridDim.x - 1) *total = (long long)(excl + block_sum);
        }
    }
    __syncthreads();

    // 3. cum_excl = the block's prefix + the rows' before it in the block
    const unsigned long long excl = s_excl;
#pragma unroll
    for (int k = 0; k < TABLE_ROWS; ++k) {
        const int g = g0 + k * TABLE_THREADS;
        if (g < n)
            cum_excl[g] = (long long)(excl + s_part[k * TABLE_WARPS + warp] + in_warp[k] - own[k]);
    }
}

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
    const int* __restrict__ gauss_sorted,       // (K,) the sorted slots' gids
    const float4* __restrict__ packets,         // (N, 12) as 3 float4 per row
    long long k, int num_tiles, int mode,
    float* __restrict__ inst_t,                 // (16, K)
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

    const int g = gauss_sorted[i];
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

// `scan` is the device's persistent scan state, int64 words: flags,
// aggregates and inclusive prefixes of `scan_blocks` blocks each, then the
// ticket; zeroed once when allocated. `epoch` numbers the launch: each
// launch on that state needs its own, in [1, 2^62).
extern "C" int gs_emission_tables(
    const void* rect_min, const void* rect_max, const void* conic, const void* mean2d,
    const void* cull_qmax, const void* tiles_touched, int n, int tile, int tight_cull,
    void* rect, void* trimmed, void* t_lo, void* cum_run, void* cum_excl, void* total,
    void* scan, long long scan_blocks, long long epoch, void* stream)
{
    const long long blocks = (n + (long long)TABLE_TILE - 1) / TABLE_TILE;
    if (n <= 0 || tile <= 0 || epoch <= 0 || epoch >= (1ll << 62) || blocks > scan_blocks)
        return (int)cudaErrorInvalidValue;
    unsigned long long* s = (unsigned long long*)scan;
    emission_tables_kernel<<<(unsigned int)blocks, TABLE_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)rect_min, (const int*)rect_max, (const float*)conic, (const float*)mean2d,
        (const float*)cull_qmax, (const int*)tiles_touched, n, tile, tight_cull, (int4*)rect,
        (unsigned char*)trimmed, (int4*)t_lo, (int4*)cum_run, (long long*)cum_excl,
        (long long*)total, s, s + scan_blocks, s + 2 * scan_blocks,
        (unsigned int*)(s + 3 * scan_blocks), (unsigned long long)epoch);
    return (int)cudaGetLastError();
}

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
    const void* keys_sorted, const void* gauss_sorted, const void* packets, long long k,
    int num_tiles, int mode, void* inst_t, void* tile_id, void* bounds, void* stream)
{
    const int threads = 256;
    const long long blocks = (k + 1 + threads - 1) / threads;  // K + 1 threads
    pack_instances_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys_sorted, (const int*)gauss_sorted, (const float4*)packets, k,
        num_tiles, mode, (float*)inst_t, (int*)tile_id, (int*)bounds);
    return (int)cudaGetLastError();
}
