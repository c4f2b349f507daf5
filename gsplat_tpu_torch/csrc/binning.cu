// Kernels Bt' and K1': tile binning for the sorted blend, on Hopper (sm_90a).
//
// Bt', `gs_emission_tables`, replaces no Pallas kernel: in the JAX package
// the tight-cull row runs (`compute_row_runs`, gsplat_tpu/ops/binning.py:171)
// and the instance prefix sum (:673-675) are XLA fusions inside the jitted
// frame. The port ran them as ~100 eager torch launches and a host read of
// the total; here they are one launch. Each gaussian's screen columns
// (rect_min, rect_max, conic, mean2d, cull_qmax, tiles_touched: 44 bytes)
// are read once, its eight rect rows run in registers in the operation
// order of the plain twin (`_emission_tables_torch`, torch's CUDA ops one
// by one: `torch.clamp`, `maximum` and `minimum` with their NaN rules
// written out, `/ tile` as torch's multiply by the reciprocal, float to
// int32 by `static_cast`), and it writes rect [rmin_x, rmin_y, max(rect_w,
// 1), tiles_post], the trimmed flag, t_lo and cum_run (8 int32 each) and
// cum_excl, the exclusive int64 prefix sum of tiles_post (89 bytes).
//
// The prefix sum has no chain between blocks. The grid is as many blocks
// as the card holds at once (the occupancy query), launched cooperatively,
// so all are resident; each owns a contiguous chunk of rows (up to 8,192 a
// round, more rounds past that) and walks it 256 rows a step, a row a
// thread, keeping each row's tiles_post in shared memory. It publishes its
// chunk's sum, waits at one grid barrier, sums the sums of the blocks
// before it (one warp over a few hundred words) and writes its cum_excl
// from shared memory; block 0 writes K. A decoupled look-back (each
// 1,024-row block's prefix from its predecessors', blocks in ticket order)
// spent 0.011 ms of 0.083 in that chain on the flagship render frame (H100
// 80GB HBM3, 700 W, `scripts/tables_ablate.py`), and its ~1,000 blocks ran
// in waves; here the grid is one wave at any N. A thread reads its row's
// int2 columns as 8-byte loads and its conic as three scalar ones, and
// writes its t_lo and cum_run rows as two int4 each (staging a warp's
// conic, t_lo and cum_run through shared memory as 512 consecutive bytes
// a load or store, and a second launch in place of the barrier, measured
// no faster on the H100: `PERF.md`). A rect row outside the rect or the
// ellipse skips its two run ends (two square roots and two divisions): its
// outputs do not depend on them.
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
// around the sort (`ops/sort.py`: St'' or St', which carry the gid as their
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

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int RUN_HMAX = 8;
constexpr int N_ROWS = 16;
constexpr int EXPAND_THREADS = 256;  // gaussians per block = slots per step
constexpr int TABLE_THREADS = 256;   // Bt': threads a block, a row each a step
constexpr int TABLE_WARPS = TABLE_THREADS / 32;
constexpr int TABLE_CHUNK_MAX = 8192;  // Bt': rows a block holds a round (tiles_post, 32 KB)
constexpr int TABLE_STATE_HEAD = 2;    // Bt''s state: the barrier's arrivals and its last number
// the tight cull's outward padding of the run ends (binning.py _RUN_PAD_*)
constexpr float RUN_PAD_REL = 1.000244140625f;  // 1 + 2^-12
constexpr float RUN_PAD_ABS = 0.00390625f;      // 2^-8 pixels

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
        // a row outside the rect or the ellipse has no run and starts at
        // rmin_x, whatever its ends: only a live row computes them (most
        // gaussians span two or three rect rows, dead ones none)
        float lo = rmin_x, run = 0.0f;
        if (row_live) {
            const float x_hi = run_end(dy_pk_hi, dy0, dy1, aq2, det_s, nb, mx, a_s, 1.0f);
            const float x_lo = run_end(dy_pk_lo, dy0, dy1, aq2, det_s, nb, mx, a_s, -1.0f);
            const float first = t_maximum(rmin_x, ceilf((x_lo - tile_m1) * inv_tile));
            const float hi = t_minimum(rmax_x1, floorf(x_hi * inv_tile));
            run = t_clamp_min(hi - first + 1.0f, 0.0f);
            if (run > 0.0f) lo = first;
        }
        t_lo[r] = static_cast<int>(lo);
        // the twin's explicit column adds: the inclusive prefix, less the row
        cum_inc = r == 0 ? run : cum_inc + run;
        cum_run[r] = static_cast<int>(cum_inc - run);
    }
    return static_cast<int>(trim ? cum_inc : (float)touched);
}

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p)
{
    return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_volatile(unsigned long long* p, unsigned long long v)
{
    *(volatile unsigned long long*)p = v;
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v)
{
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    return v;
}

// Bt''s pointers and sizes, one kernel argument
struct TableIo {
    const int2* rect_min;         // (N, 2)
    const int2* rect_max;         // (N, 2)
    const float* conic;           // (N, 3)
    const float2* mean2d;         // (N, 2)
    const float* cull_qmax;       // (N,)
    const int* tiles_touched;     // (N,)
    int4* rect;                   // (N, 4) rmin_x, rmin_y, max(rect_w, 1), tiles_post
    unsigned char* trimmed;       // (N,)
    int4* t_lo;                   // (N, 8)
    int4* cum_run;                // (N, 8)
    long long* cum_excl;          // (N,)
    long long* total;             // () K
    int n, tile, tight_cull;
};

// 1. One round's tables of the block's rows [base, base + rows), a row a
// thread, TABLE_THREADS consecutive rows a step. Each row's tiles_post
// goes to s_tp; returns the thread's int64 sum of them.
__device__ __forceinline__ unsigned long long table_rows(
    const TableIo& io, long long base, int rows, int* s_tp)
{
    const float ftile = (float)io.tile, tile_m1 = (float)(io.tile - 1);
    const float inv_tile = 1.0f / (float)io.tile;
    unsigned long long acc = 0;
    for (int i = threadIdx.x; i < rows; i += TABLE_THREADS) {
        const long long g = base + i;
        int lo[RUN_HMAX], cr[RUN_HMAX];
#pragma unroll
        for (int r = 0; r < RUN_HMAX; ++r) lo[r] = cr[r] = 0;
        const int2 r0 = __ldg(io.rect_min + g), r1 = __ldg(io.rect_max + g);
        const int touched = __ldg(io.tiles_touched + g);
        bool trim = false;
        int tp = touched;
        if (io.tight_cull) {
            const float2 m = __ldg(io.mean2d + g);
            tp = row_runs(r0.x, r0.y, r1.x, r1.y, touched, __ldg(io.conic + 3 * g),
                          __ldg(io.conic + 3 * g + 1), __ldg(io.conic + 3 * g + 2), m.x, m.y,
                          __ldg(io.cull_qmax + g), ftile, tile_m1, inv_tile, trim, lo, cr);
        }
        const int w = (int)((unsigned)r1.x - (unsigned)r0.x);
        io.rect[g] = make_int4(r0.x, r0.y, w > 1 ? w : 1, tp);
        io.trimmed[g] = trim;
        io.t_lo[2 * g] = make_int4(lo[0], lo[1], lo[2], lo[3]);
        io.t_lo[2 * g + 1] = make_int4(lo[4], lo[5], lo[6], lo[7]);
        io.cum_run[2 * g] = make_int4(cr[0], cr[1], cr[2], cr[3]);
        io.cum_run[2 * g + 1] = make_int4(cr[4], cr[5], cr[6], cr[7]);
        s_tp[i] = tp;
        acc += (unsigned long long)(long long)tp;
    }
    return acc;
}

// The block's sum of `acc` (int64, wrapping as torch's cumsum does) into
// its slot of this round's block sums
__device__ __forceinline__ void publish_block_sum(unsigned long long acc,
                                                  unsigned long long* slot,
                                                  unsigned long long* s_sum)
{
    const int t = threadIdx.x;
    acc = warp_sum64(acc);
    if ((t & 31) == 0) s_sum[t >> 5] = acc;
    __syncthreads();
    if (t == 0) {
        unsigned long long b = 0;
        for (int w = 0; w < TABLE_WARPS; ++w) b += s_sum[w];
        store_volatile(slot, b);
    }
    __syncthreads();  // s_sum is written again in the next round
}

// Every block of the grid waits here until all have arrived, blocks the
// cooperative launch made resident together: thread 0 counts the block in
// (its writes fenced before), the last one resets the count and publishes
// `target`, the barrier's number (numbers only grow, launch after launch,
// so an earlier barrier's reads as not yet released)
__device__ __forceinline__ void grid_barrier(unsigned long long* state, unsigned long long target)
{
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned int* arrived = reinterpret_cast<unsigned int*>(state);
        __threadfence();
        if (atomicAdd(arrived, 1u) == gridDim.x - 1) {
            atomicExch(arrived, 0u);
            __threadfence();
            store_volatile(state + 1, target);
        } else {
            while (load_volatile(state + 1) < target) __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// 2. Warp 0 sums this round's block sums: those of the blocks before this
// one into s_excl[0], all into s_excl[1]
__device__ __forceinline__ void block_prefix(const unsigned long long* sums,
                                             unsigned long long* s_excl)
{
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x, blk = blockIdx.x;
        unsigned long long before = 0, all = 0;
        for (int b = lane; b < (int)gridDim.x; b += 32) {
            const unsigned long long v = __ldcg(sums + b);
            all += v;
            if (b < blk) before += v;
        }
        before = warp_sum64(before);
        all = warp_sum64(all);
        if (lane == 0) {
            s_excl[0] = before;
            s_excl[1] = all;
        }
    }
    __syncthreads();
}

// 3. cum_excl of the block's rows: `prefix` plus each row's exclusive scan
// in the chunk, TABLE_THREADS rows a step (a warp's shuffle scan, then the
// warps' sums), from the rows' tiles_post in s_tp
__device__ __forceinline__ void write_cum_excl(long long* cum_excl, long long base, int rows,
                                               unsigned long long prefix, const int* s_tp,
                                               unsigned long long* s_sum)
{
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    for (int i0 = 0; i0 < rows; i0 += TABLE_THREADS) {
        const int i = i0 + t;
        const unsigned long long v = i < rows ? (unsigned long long)(long long)s_tp[i] : 0ull;
        unsigned long long incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long u = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += u;
        }
        if (lane == 31) s_sum[warp] = incl;
        __syncthreads();
        unsigned long long before = 0, step = 0;
#pragma unroll
        for (int w = 0; w < TABLE_WARPS; ++w) {
            const unsigned long long s = s_sum[w];
            step += s;
            if (w < warp) before += s;
        }
        if (i < rows) cum_excl[base + i] = (long long)(prefix + before + incl - v);
        prefix += step;
        __syncthreads();
    }
}

// The block's rows in round r: `chunk` consecutive ones, the rounds' chunks
// in block order
__device__ __forceinline__ int rows_of(int n, int chunk, int r, long long& base)
{
    base = ((long long)r * gridDim.x + blockIdx.x) * chunk;
    const long long left = (long long)n - base;
    return left <= 0 ? 0 : left < chunk ? (int)left : chunk;
}

// Bt': persistent blocks, all resident at once. In each round a block
// computes its chunk's tables (1) and publishes its chunk's sum; after one
// grid barrier it sums the earlier blocks' (2) and writes its cum_excl
// from the tiles_post it kept in shared memory (3); block 0 writes K.
__global__ void __launch_bounds__(TABLE_THREADS) emission_tables_kernel(
    TableIo io, int chunk, int rounds,
    unsigned long long* state,  // TABLE_STATE_HEAD words, then (rounds, blocks) sums
    unsigned long long number)  // the first barrier's number
{
    __shared__ int s_tp[TABLE_CHUNK_MAX];
    __shared__ unsigned long long s_sum[TABLE_WARPS];
    __shared__ unsigned long long s_excl[2];

    unsigned long long* sums = state + TABLE_STATE_HEAD;
    unsigned long long carry = 0;  // the earlier rounds' sum
    for (int r = 0; r < rounds; ++r) {
        long long base;
        const int rows = rows_of(io.n, chunk, r, base);
        const unsigned long long acc = table_rows(io, base, rows, s_tp);
        unsigned long long* round_sums = sums + (long long)r * gridDim.x;
        publish_block_sum(acc, round_sums + blockIdx.x, s_sum);
        grid_barrier(state, number + r);
        block_prefix(round_sums, s_excl);
        write_cum_excl(io.cum_excl, base, rows, carry + s_excl[0], s_tp, s_sum);
        carry += s_excl[1];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *io.total = (long long)carry;
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

// Bt''s launch: blocks, rows a block a round (a multiple of 32, at most
// TABLE_CHUNK_MAX), rounds and the state's int64 words for `n` rows. The
// grid is as many blocks as the card holds at once (the SMs times the
// kernel's blocks an SM, cached a device), or fewer for a small N.
struct TableLayout { long long blocks, chunk, rounds, words; };

cudaError_t table_layout(long long n, TableLayout* l)
{
    static int per_sm_of[64], sms_of[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
    if (per_sm_of[dev] == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm_of[dev], (const void*)emission_tables_kernel, TABLE_THREADS, 0);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess || per_sm_of[dev] < 1) {
            per_sm_of[dev] = 0;
            return err != cudaSuccess ? err : cudaErrorInvalidValue;
        }
    }
    const long long most = (long long)sms_of[dev] * per_sm_of[dev];
    l->blocks = std::min(most, std::max(1ll, (n + 31) / 32));
    const long long share = (n + l->blocks - 1) / l->blocks;
    l->chunk = std::min((long long)TABLE_CHUNK_MAX, std::max(32ll, (share + 31) / 32 * 32));
    l->rounds = std::max(1ll, (n + l->blocks * l->chunk - 1) / (l->blocks * l->chunk));
    l->words = TABLE_STATE_HEAD + l->rounds * l->blocks;
    return cudaSuccess;
}

}  // namespace

// out[0] blocks, out[1] rows a block a round, out[2] rounds, out[3] the
// state's int64 words
extern "C" int gs_emission_layout(long long n, long long* out)
{
    TableLayout l;
    if (n < 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = table_layout(n, &l);
    if (err != cudaSuccess) return (int)err;
    out[0] = l.blocks;
    out[1] = l.chunk;
    out[2] = l.rounds;
    out[3] = l.words;
    return 0;
}

// `state` is the device's Bt' state, `state_words` int64 words (at least
// the layout's), zeroed once when allocated: the barrier's count of
// arrivals (0 before and after a launch) and its last number, then the
// block sums. `number` is this launch's first barrier number: greater than
// any an earlier launch on that state used, which used `rounds` from its
// own.
extern "C" int gs_emission_tables(
    const void* rect_min, const void* rect_max, const void* conic, const void* mean2d,
    const void* cull_qmax, const void* tiles_touched, int n, int tile, int tight_cull,
    void* rect, void* trimmed, void* t_lo, void* cum_run, void* cum_excl, void* total,
    void* state, long long state_words, long long number, void* stream)
{
    TableLayout l;
    if (n <= 0 || tile <= 0 || number <= 0 || number >= (1ll << 62))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = table_layout(n, &l);
    if (err != cudaSuccess) return (int)err;
    if (l.words > state_words) return (int)cudaErrorInvalidValue;
    TableIo io{(const int2*)rect_min, (const int2*)rect_max, (const float*)conic,
               (const float2*)mean2d, (const float*)cull_qmax, (const int*)tiles_touched,
               (int4*)rect, (unsigned char*)trimmed, (int4*)t_lo, (int4*)cum_run,
               (long long*)cum_excl, (long long*)total, n, tile, tight_cull};
    int chunk = (int)l.chunk, rounds = (int)l.rounds;
    unsigned long long* s = (unsigned long long*)state;
    unsigned long long first = (unsigned long long)number;
    void* args[] = {&io, &chunk, &rounds, &s, &first};
    err = cudaLaunchCooperativeKernel(emission_tables_kernel, dim3((unsigned)l.blocks),
                                      dim3(TABLE_THREADS), args, 0, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
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
