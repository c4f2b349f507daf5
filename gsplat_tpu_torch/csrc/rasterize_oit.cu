// Kernels K5' and K6': the order-independent (OIT) blend and its backward,
// on Hopper (sm_90a).
//
// Replace the Pallas kernels `_oit_fwd_kernel` (gsplat_tpu/ops/rasterize_pallas.py
// :897, launched by `_run_oit_forward`, :948) and `_oit_bwd_kernel` (:974,
// launched by `_run_oit_backward`, :1095) of the opt-in blend mode
// `RenderSettings.blend_mode = "oit"`. Per pixel, commutative sums over every
// kept (pixel, instance) pair of the pixel's tile replace the sorted blend's
// front-to-back recurrence (z = invz):
//   N = sum alpha z^2 [r, g, b, z],  D = sum alpha z^2,  T = exp(sum log1p(-alpha)).
// The quotient N / max(D, 1e-8) * (1 - T) is composed outside, in plain torch,
// and differentiated there by autograd (rasterize_pallas.py:1306-1324).
// Power, alpha and the keep rule are `gs::pair_power` and `gs::pair_alpha`
// (common.cuh), the functions the sorted kernels K2' and K3' call, built with
// -fmad=false: K6' sees exactly the pairs K5' kept.
//
// gs_oit_fwd (K5'): the shape of K2' (rasterize_fwd.cu). One block of 256
//   threads per 16x16 tile. The block stages its range in batches of 256
//   instances, each as three float4 and its pixel box and margin-padded tau
//   (`gs::pixel_box`). A warp owns an 8x4 block of the tile
//   (`gs::warp_pixel`, `gs::warp_rect`) and, per 32 staged instances, one
//   `__ballot_sync` of `gs::reaches` gives the instances it walks; the rest
//   cannot be kept at any of its pixels. Each walked pair is predicated, not
//   branched. OIT has no early stop, so every pixel still adds its kept pairs
//   in the range's order, and a culled pair is one no pixel of the warp
//   keeps: the sums are bit for bit those of the walk over every instance
//   (the plain twin, `blend_oit_packed_torch`). It writes
//   [N0, N1, N2, N3, D, expf(L), 0, 0] with L = sum log1pf(-alpha) at the
//   pixel's row-major index; an empty tile writes N = D = 0 and T = 1.
//   Bound on the card: operations. Each evaluated pair costs ~11 float32
//   operations before the keep test and each kept pair ~18 more (expf and
//   log1pf counted as one each), against 40 bytes per instance read once per
//   tile and amortized over 256 pixels.
//
// gs_oit_bwd (K6'): per-instance gradient rows from the cotangents of the raw
//   sums. With K = dN . [r, g, b, z] + dD and rT = dT * T_final (the
//   cotangent of L), a kept pair has
//     dalpha = z^2 K - rT / (1 - alpha),  dgm = op dalpha g,
//   and adds to its instance's rows (rasterize_pallas.py:1018-1083)
//     d mean2d = dgm (2 ca dx + cb dy, 2 cc dy + cb dx)  on the folded conic
//     d conic  = dgm (-dx^2 / 2, -dx dy, -dy^2 / 2)      in the true basis
//     d opacity = g dalpha  (summed directly, not K6's m0 / max(op, 1e-30))
//     d rgb  += alpha dN[0:3]                   (times z^2 once at the end)
//     d z    += 2z alpha K + z^2 alpha dN[3]    (the invz chain through the
//                                                depth weight and the feature)
//   The alpha clamp at 0.99 is straight-through (rasterize_jnp.py:233-236).
//   A row depends only on its own instance and its tile's pixels (no
//   transmittance prefix), so one thread owns one instance slot and keeps
//   its eleven sums in registers; each row is written once, with no
//   shuffles and no atomics.
//   - The walk: only the pixels of the instance's `gs::pixel_box` in its
//     tile and, where the box is finite, in each row's `gs::row_span` (the
//     ellipse's chord at that row, padded as the box is), in row-major
//     order. A pixel outside cannot keep the pair, so every sum adds the
//     same kept pairs in the same order as the walk over all 256 pixels (the
//     plain twin, `blend_oit_bwd_packed_torch`): bit for bit its rows. Most
//     of what it walks is kept (`chip_smoke.py` prints the walked pairs).
//   - The balance. Walk lengths are heavy-tailed (an instance of a large
//     splat walks its whole tile, most walk a few dozen pixels), and a warp
//     takes as long as its longest lane.
//     A first pass (`oit_bwd_kernel_rank`, 256 threads per 256-slot chunk of
//     one tile) stores each slot's walk, one byte per row, and sorts the
//     chunk's slots by walk length (bitonic, in shared memory). The main
//     pass (`oit_bwd_kernel`) runs one warp per 32 consecutive ranks of a
//     chunk: it stages the tile's 256 per-pixel cotangents (dN0..3 as a
//     float4, dD and rT as a float2: 6 KB) and every lane makes the warp's
//     trip count (its last rank's walk, the longest), one pixel per trip,
//     predicated past its own. Launches are over chunks, not tiles: two
//     one-block plan kernels write each tile's first block (prefix sums of
//     ceil(len / 256) and ceil(len / 32)), and a block finds its tile by a
//     binary search over them, so a long range spreads over many blocks and
//     an empty tile costs none.
//   Bound on the card: operations, ~11 per evaluated pair and ~55 more per
//   kept pair, against 40 bytes per instance in and 40 out. Not done yet:
//   the main pass runs well under the card's instruction rate; without `ncu`
//   what stalls it is not measured.
//
// The tiles' ranges must be disjoint and cover the K instance slots (the
// per-frame buffer of `pack_bins` is so): K6' writes each slot once.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;
using gs::TILE;

constexpr unsigned FULL = 0xffffffffu;
constexpr int RANK_CHUNK = 256;  // slots K6''s first pass orders together
constexpr int WALK_GROUP = 32;   // ranks (and threads, one warp) per block of K6''s main pass
constexpr int PLAN_THREADS = 1024;

__global__ void __launch_bounds__(PPT) oit_fwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x,
    float* __restrict__ out)           // (T, 256, 8)
{
    // the staged instances, 12 floats each as three float4 loads:
    // [mx, my, ca, cb], [cc, op, r, g], [b, invz, -, -]
    __shared__ float4 batch[3][PPT];
    __shared__ float box[5][PPT];  // x0, x1, y0, y1, tau_m

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int tx0 = (t % grid_x) * TILE;
    const int ty0 = (t / grid_x) * TILE;
    const int pix = gs::warp_pixel(warp, lane);
    const float px = (float)(tx0 + pix % TILE);
    const float py = (float)(ty0 + pix / TILE);
    float wx0, wx1, wy0, wy1;
    gs::warp_rect(warp, tx0, ty0, wx0, wx1, wy0, wy1);
    const int s = tile_start[t];
    const int e = tile_end[t];

    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, n3 = 0.0f, d = 0.0f, l = 0.0f;

    for (int b0 = s; b0 < e; b0 += PPT) {
        __syncthreads();  // the previous batch's readers are done
        const int nb = min(PPT, e - b0);
        if (tid < nb) {
            float v[N_ATTR];
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) v[r] = inst_t[r * k + b0 + tid];
            batch[0][tid] = make_float4(v[0], v[1], v[2], v[3]);
            batch[1][tid] = make_float4(v[4], v[5], v[6], v[7]);
            batch[2][tid] = make_float4(v[8], v[9], 0.0f, 0.0f);
            gs::pixel_box(v[0], v[1], v[2], v[3], v[4], v[5],
                          box[0][tid], box[1][tid], box[2][tid], box[3][tid], box[4][tid]);
        }
        __syncthreads();
        for (int c = 0; c < nb; c += 32) {
            const int jl = c + lane;
            const int jr = jl < nb ? jl : 0;
            const float4 r0 = batch[0][jr];
            const float r4 = batch[1][jr].x;
            unsigned m = __ballot_sync(
                FULL, jl < nb && gs::reaches(r0.x, r0.y, r0.z, r0.w, r4, box[4][jl], box[0][jl],
                                             box[1][jl], box[2][jl], box[3][jl],
                                             wx0, wx1, wy0, wy1));
            while (m) {
                const int j = c + __ffs(m) - 1;
                m &= m - 1;
                // predicated, not branched: the warp runs the pair whenever
                // one lane keeps it, and a lane that does not keeps its sums
                const float4 q0 = batch[0][j];
                const float4 q1 = batch[1][j];
                const float4 q2 = batch[2][j];
                float dx, dy, power, g, alpha;
                const bool pass = gs::pair_power(q0.x, q0.y, q0.z, q0.w, q1.x, px, py,
                                                 dx, dy, power);
                const bool keep = gs::pair_alpha(power, q1.y, g, alpha) && pass;
                const float z = q2.y;
                const float aw = alpha * (z * z);
                n0 = keep ? n0 + aw * q1.z : n0;
                n1 = keep ? n1 + aw * q1.w : n1;
                n2 = keep ? n2 + aw * q2.x : n2;
                n3 = keep ? n3 + aw * z : n3;
                d = keep ? d + aw : d;
                l = keep ? l + log1pf(-alpha) : l;
            }
        }
    }

    float* o = out + ((long long)t * PPT + pix) * 8;
    o[0] = n0;
    o[1] = n1;
    o[2] = n2;
    o[3] = n3;
    o[4] = d;
    o[5] = expf(l);
    o[6] = 0.0f;
    o[7] = 0.0f;
}

// first[t] = the first block of tile t when each tile's range is cut in
// units of CHUNK slots (the sum of ceil(len / CHUNK) over the tiles before
// it); first[num_tiles] = the number of blocks. One block: each thread sums
// a run of tiles, a scan in shared memory gives the runs' offsets.
template <int CHUNK>
__global__ void __launch_bounds__(PLAN_THREADS) oit_bwd_kernel_plan(
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int num_tiles,
    int* __restrict__ first)           // (T + 1,)
{
    __shared__ int part[PLAN_THREADS];
    const int tid = threadIdx.x;
    const int per = (num_tiles + PLAN_THREADS - 1) / PLAN_THREADS;
    const int t0 = min(tid * per, num_tiles);
    const int t1 = min(t0 + per, num_tiles);
    int sum = 0;
    for (int t = t0; t < t1; ++t) sum += (max(tile_end[t] - tile_start[t], 0) + CHUNK - 1) / CHUNK;
    part[tid] = sum;
    __syncthreads();
    for (int off = 1; off < PLAN_THREADS; off <<= 1) {  // inclusive scan
        const int v = tid >= off ? part[tid - off] : 0;
        __syncthreads();
        part[tid] += v;
        __syncthreads();
    }
    int run = part[tid] - sum;
    for (int t = t0; t < t1; ++t) {
        first[t] = run;
        run += (max(tile_end[t] - tile_start[t], 0) + CHUNK - 1) / CHUNK;
    }
    if (tid == PLAN_THREADS - 1) first[num_tiles] = part[tid];
}

// The block's tile: the last t with first[t] <= b (empty tiles own no block).
__device__ __forceinline__ int tile_of_block(const int* __restrict__ first, int num_tiles, int b)
{
    int lo = 0, hi = num_tiles;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (first[mid] <= b) lo = mid; else hi = mid;
    }
    return lo;
}

// An instance's walk in its tile (origin tx, ty), one byte per tile row:
// the first and last column (tile offsets, c0 << 4 | c1) of the row's
// pixels inside its `gs::pixel_box` and, where the box is finite, inside
// `gs::row_span`; a row with c0 > c1 (0xf0) is not walked. Returns the
// walk's pixel count; the 16 bytes go to `rows` (four words, row 4w + j in
// byte j of word w).
__device__ __forceinline__ int walk_rows(float mx, float my, float ca, float cb, float cc,
                                         float op, int tx, int ty, unsigned rows[4])
{
    float x0, x1, y0, y1, tau;
    gs::pixel_box(mx, my, ca, cb, cc, op, x0, x1, y0, y1, tau);
    const bool spans = isfinite(tau);
    const float bx0 = ceilf(fmaxf(x0, (float)tx));
    const float bx1 = floorf(fminf(x1, (float)(tx + TILE - 1)));
    const float by0 = fmaxf(y0, (float)ty);
    const float by1 = fminf(y1, (float)(ty + TILE - 1));
    int n = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) rows[w] = 0u;
#pragma unroll
    for (int qy = 0; qy < TILE; ++qy) {
        const float py = (float)(ty + qy);
        float f0 = bx0, f1 = bx1;
        if (spans) {
            float s0, s1;
            gs::row_span(mx, my, ca, cb, cc, tau, py, s0, s1);
            // fmaxf/fminf pass the box's edge where the span is NaN
            f0 = ceilf(fmaxf(s0, bx0));
            f1 = floorf(fminf(s1, bx1));
        }
        unsigned byte = 0xf0u;
        if (py >= by0 && py <= by1 && f0 <= f1) {
            const int c0 = (int)f0 - tx, c1 = (int)f1 - tx;
            byte = (unsigned)(c0 << 4 | c1);
            n += c1 - c0 + 1;
        }
        rows[qy >> 2] |= byte << ((qy & 3) * 8);
    }
    return n;
}

// K6', first pass: per 256-slot chunk of a tile, each slot's walk
// (`walk_rows`, stored in `walks`) and the chunk's slots in ascending order
// of its pixel count (`perm[base + r]` = count << 8 | the offset in the
// chunk of the slot of rank r), so that the main pass gives a warp lanes
// whose walks are about as long.
__global__ void __launch_bounds__(RANK_CHUNK) oit_bwd_kernel_rank(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int num_tiles,
    int grid_x,
    const int* __restrict__ first,     // (T + 1,) in RANK_CHUNK units
    int* __restrict__ perm,            // (K,)
    uint4* __restrict__ walks)         // (K,)
{
    __shared__ int skey[RANK_CHUNK];
    const int b = blockIdx.x;
    if (b >= first[num_tiles]) return;  // the grid is an upper bound
    const int t = tile_of_block(first, num_tiles, b);
    const int tid = threadIdx.x;
    const long long base = (long long)tile_start[t] + (long long)(b - first[t]) * RANK_CHUNK;
    const long long i = base + tid;
    const bool valid = i < tile_end[t];
    int key = 0x7fffffff;  // past every valid key: ranks [0, len) are the valid slots
    if (valid) {
        unsigned rows[4];
        const int n = walk_rows(inst_t[0 * k + i], inst_t[1 * k + i], inst_t[2 * k + i],
                                inst_t[3 * k + i], inst_t[4 * k + i], inst_t[5 * k + i],
                                (t % grid_x) * TILE, (t / grid_x) * TILE, rows);
        walks[i] = make_uint4(rows[0], rows[1], rows[2], rows[3]);
        key = (n << 8) | tid;  // n <= 256
    }
    skey[tid] = key;
    for (int size = 2; size <= RANK_CHUNK; size <<= 1) {  // bitonic sort, ascending
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            __syncthreads();
            const int partner = tid ^ stride;
            if (partner > tid) {
                const int x = skey[tid], y = skey[partner];
                if ((x > y) == ((tid & size) == 0)) {
                    skey[tid] = y;
                    skey[partner] = x;
                }
            }
        }
    }
    __syncthreads();
    if (valid) perm[i] = skey[tid];  // the slot's offset in the chunk, its count << 8
}

// K6', main pass: a block is a group of WALK_GROUP ranks of one chunk; a
// thread walks its slot's pixels in row-major order, one pixel per trip of
// one loop (a row's start is a byte read, so lanes that change rows at
// different trips do not serialize a row's set-up).
__global__ void __launch_bounds__(WALK_GROUP) oit_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int num_tiles,
    int grid_x,
    const int* __restrict__ first,     // (T + 1,) in WALK_GROUP units
    const int* __restrict__ perm,      // (K,) from the first pass
    const uint4* __restrict__ walks,   // (K,) from the first pass
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent, 16-byte aligned
    float* __restrict__ dinst)         // (10, K)
{
    constexpr int GROUPS = RANK_CHUNK / WALK_GROUP;
    __shared__ float4 cot_n[PPT];  // dN0..3 per pixel
    __shared__ float2 cot_d[PPT];  // dD, rT per pixel

    const int b = blockIdx.x;
    if (b >= first[num_tiles]) return;  // the grid is an upper bound
    const int t = tile_of_block(first, num_tiles, b);
    const int tid = threadIdx.x;
    for (int p = tid; p < PPT; p += WALK_GROUP) {
        const long long pix = (long long)t * PPT + p;
        const float4* d = reinterpret_cast<const float4*>(dout + pix * 8);
        const float4 d1 = d[1];
        cot_n[p] = d[0];
        cot_d[p] = make_float2(d1.x, d1.y * fwd[pix * 8 + 5]);  // rT = dT * T_final
    }
    __syncthreads();

    const int j = b - first[t];
    const long long base = (long long)tile_start[t] + (long long)(j / GROUPS) * RANK_CHUNK;
    const long long r = base + (j % GROUPS) * WALK_GROUP + tid;  // this thread's rank
    const long long e = tile_end[t];
    if (r >= e) return;
    const int key = perm[r];
    const long long i = base + (key & 0xff);
    const int count = key >> 8;
    // the warp's trips: the count of its last rank, the largest (the ranks
    // are in ascending order of count)
    const long long last = min(r - (tid & 31) + 31, e - 1);
    const int trips = perm[last] >> 8;

    const float mx = inst_t[0 * k + i], my = inst_t[1 * k + i];
    const float ca = inst_t[2 * k + i], cb = inst_t[3 * k + i], cc = inst_t[4 * k + i];
    const float op = inst_t[5 * k + i];
    const float rr = inst_t[6 * k + i], gr = inst_t[7 * k + i], bl = inst_t[8 * k + i];
    const float z = inst_t[9 * k + i];
    const float z2 = z * z;
    const uint4 wk = walks[i];
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f, v5 = 0.0f;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, w = 0.0f;

    const int tx = (t % grid_x) * TILE;
    const int ty = (t / grid_x) * TILE;
    int qy = -1, qx = 1, c1 = 0;
    float fx = 0.0f, fy = 0.0f;  // the pixel's coordinates, stepped (exact integers)
    // one pixel per trip, the same trips for the whole warp, so that its
    // lanes stay together; a lane past its count computes and keeps nothing
    for (int n = 0; n < trips; ++n) {
        const bool on = n < count;
        if (on && qx > c1) {
            do {  // the next walked row: one exists while n < count
                ++qy;
                const unsigned word = qy < 8 ? (qy < 4 ? wk.x : wk.y) : (qy < 12 ? wk.z : wk.w);
                const unsigned byte = (word >> ((qy & 3) * 8)) & 0xffu;
                qx = (int)(byte >> 4);
                c1 = (int)(byte & 0xfu);
            } while (qx > c1);
            fx = (float)(tx + qx);
            fy = (float)(ty + qy);
        }
        const int p = on ? qy * TILE + qx : 0;
        const float px = fx;
        qx += on ? 1 : 0;
        fx = on ? fx + 1.0f : fx;
        float dx, dy, power, g, alpha;
        const bool pass = gs::pair_power(mx, my, ca, cb, cc, px, fy, dx, dy, power);
        const bool keep = gs::pair_alpha(power, op, g, alpha) && pass && on;
        const float4 cn = cot_n[p];
        const float2 cd = cot_d[p];
        const float dn0 = cn.x, dn1 = cn.y, dn2 = cn.z, dn3 = cn.w;
        const float kk = (((dn0 * rr + dn1 * gr) + dn2 * bl) + dn3 * z) + cd.x;
        const float inv_one_m = 1.0f / (1.0f - alpha);
        const float dalpha = z2 * kk - cd.y * inv_one_m;
        const float dgm = (op * dalpha) * g;
        v0 = keep ? v0 + dgm * ((ca + ca) * dx + cb * dy) : v0;
        v1 = keep ? v1 + dgm * ((cc + cc) * dy + cb * dx) : v1;
        v2 = keep ? v2 + -0.5f * (dgm * dx * dx) : v2;
        v3 = keep ? v3 + -(dgm * dx * dy) : v3;
        v4 = keep ? v4 + -0.5f * (dgm * dy * dy) : v4;
        v5 = keep ? v5 + g * dalpha : v5;
        a0 = keep ? a0 + alpha * dn0 : a0;
        a1 = keep ? a1 + alpha * dn1 : a1;
        a2 = keep ? a2 + alpha * dn2 : a2;
        a3 = keep ? a3 + alpha * dn3 : a3;
        w = keep ? w + alpha * kk : w;
    }

    dinst[0 * k + i] = v0;
    dinst[1 * k + i] = v1;
    dinst[2 * k + i] = v2;
    dinst[3 * k + i] = v3;
    dinst[4 * k + i] = v4;
    dinst[5 * k + i] = v5;
    dinst[6 * k + i] = z2 * a0;
    dinst[7 * k + i] = z2 * a1;
    dinst[8 * k + i] = z2 * a2;
    dinst[9 * k + i] = (z + z) * w + z2 * a3;
}

}  // namespace

extern "C" int gs_oit_fwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, void* out, void* stream)
{
    oit_fwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        grid_x, (float*)out);
    return (int)cudaGetLastError();
}

// `plan` is scratch for 2 (num_tiles + 1) ints, `perm` for k ints and
// `walks` for k 16-byte rows (16-byte aligned). Each grid is an upper bound
// of its blocks (each tile adds at most one partial chunk); blocks past the
// plan's count return at once.
extern "C" int gs_oit_bwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, void* plan, void* perm, void* walks, const void* fwd,
    const void* dout, void* dinst, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const int* ts = (const int*)tile_start;
    const int* te = (const int*)tile_end;
    int* first_rank = (int*)plan;
    int* first_walk = first_rank + num_tiles + 1;
    oit_bwd_kernel_plan<RANK_CHUNK><<<1, PLAN_THREADS, 0, st>>>(ts, te, num_tiles, first_rank);
    oit_bwd_kernel_plan<WALK_GROUP><<<1, PLAN_THREADS, 0, st>>>(ts, te, num_tiles, first_walk);
    const long long rank_blocks = (k + RANK_CHUNK - 1) / RANK_CHUNK + num_tiles;
    oit_bwd_kernel_rank<<<(unsigned)rank_blocks, RANK_CHUNK, 0, st>>>(
        (const float*)inst_t, k, ts, te, num_tiles, grid_x, first_rank, (int*)perm,
        (uint4*)walks);
    const long long walk_blocks = (k + WALK_GROUP - 1) / WALK_GROUP + num_tiles;
    oit_bwd_kernel<<<(unsigned)walk_blocks, WALK_GROUP, 0, st>>>(
        (const float*)inst_t, k, ts, te, num_tiles, grid_x, first_walk, (const int*)perm,
        (const uint4*)walks, (const float*)fwd, (const float*)dout, (float*)dinst);
    return (int)cudaGetLastError();
}
