// Kernel K3': the backward of the sorted blend, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_kernel` of gsplat_tpu/ops/rasterize_pallas.py
// (:605, launched by `_run_backward` from the custom VJP `blend_bwd`,
// :1214-1243). The TPU kernel re-walks each tile's 128-aligned instance
// chunks with pixels on sublanes, turns the back-to-front recurrence into a
// lane cumsum and builds the gradient rows from six pixel moments with one
// MXU matmul. Here the shape is the forward's (K2'): one block of 256
// threads per 16x16 tile, one thread per pixel, walking the tile's sorted
// [start, end) range front to back.
//
// Per pixel, from the forward output and the cotangent (both (T, 256, 8)):
//   S_total = sum_ch fwd[ch] * dout[ch] over r, g, b, invdepth;
//   bgdot   = dout[final_T] * fwd[final_T]  (rasterize_pallas.py:628-635).
// Walking the range with the forward's own keep and stop decisions
// (`gs::pair_power` and `gs::pair_alpha`, shared with K2', and the same T
// recurrence), for each blended instance j:
//   c      = sum_ch feat_j[ch] * dout[ch];  w = alpha * T;  prefix += w * c
//   dalpha = T * c - (S_total - prefix + bgdot) / (1 - alpha)  (:679-687)
//   dgm    = op * dalpha * g
// and the pixel's terms of instance j's ten gradient rows (:729-742):
//   d mean2d = dgm * (2 ca dx + cb dy, 2 cc dy + cb dx)  on the folded conic
//   d conic  = dgm * (-dx^2 / 2, -dx dy, -dy^2 / 2)      in the true basis
//   d opacity = g * dalpha   (summed directly, not K3's m0 / max(op, 1e-30))
//   d rgb, d invz = w * dout[0..3]
// The alpha clamp at 0.99 is straight-through (rasterize_jnp.py:112-117).
//
// Bound on the card: operations. Every evaluated (pixel, instance) pair
// redoes the forward's ~11 operations before the keep test, and every
// blended pair adds ~45 for the gradient terms, against 40 bytes per
// instance read and 40 written once. Each row is a sum over the tile's 256
// pixels, and that sum is where a simple design loses: ten five-level
// shuffle butterflies per (warp, instance) issue 50 shuffles, at one
// warp-wide shuffle per SM and clock (a quarter of the float32 add rate).
// Streaming is a tenth of the time (the skeleton P2').
//
// Design:
// - The warp cull of K2' (`gs::pixel_box`, `gs::reaches`, common.cuh): the
//   block stages 64 instances at a time as three float4 each with their
//   pixel boxes, and each warp (an 8x4 block of pixels) walks only the
//   instances that can be kept at one of its pixels, found with two ballots
//   per batch.
// - A transposed reduce-scatter over groups of G = 3 walked instances: each
//   lane holds the 3 x 10 terms of the group (zeros where it did not
//   blend) in 32 registers, and one butterfly whose level o sends the half
//   of the lane's values its partner keeps leaves lane l with the warp's
//   sum of entry l = 10 g + r: 31 shuffles per group, ~10 per instance. A
//   group no lane contributes to is skipped (`__any_sync`).
// - The group's three pairs are predicated, not branched, so their loads,
//   exp and reciprocal overlap; only T, prefix and done carry from one to
//   the next. 63 registers: four blocks per SM, no spills.
// - Lane l writes its entry to `partial[warp][r][j]`; the warp records the
//   instances it wrote in a 64-bit mask, and after the batch the block sums
//   the 8 warps' written partials per (row, instance) and writes them
//   coalesced. Each instance slot belongs to exactly one tile, so every
//   output column is written once, by its tile's block, with no atomics.
// - A warp whose pixels all stopped leaves the batch; the block stops once
//   all its pixels are done, and the instances past that point get zero
//   rows.
// Later work: fuse the per-gaussian reduce (K4') into the epilogue with
// atomics, balance tiles of very different lengths.
//
// Output (10, K) float32 rows: [d mx, d my, d a, d b, d c, d op, d r, d g,
// d b, d invz] per sorted instance slot.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;
using gs::TILE;

constexpr int BATCH = 64;  // instances staged per round
constexpr int WARPS = PPT / 32;
constexpr int N_GRAD = 10;
constexpr int G = 3;       // instances per reduce-scatter: G * N_GRAD <= 32
constexpr unsigned FULL = 0xffffffffu;
static_assert(G * N_GRAD <= 32, "one entry per lane");

// Warp reduce-scatter of x[0..31]: on return x[0] of lane l is the sum over
// the warp's lanes of their x[l]. Level o keeps the upper half of the live
// values on lanes with bit o set and the lower half on the others, and adds
// the partner's copy of the kept half: 16 + 8 + 4 + 2 + 1 = 31 shuffles.
// Each level is its own instantiation, so every index into x is a constant
// and x stays in registers (a shift-stepped loop over the levels was not
// unrolled and put x on the stack).
template <int O>
__device__ __forceinline__ void scatter_level(float (&x)[32], int lane)
{
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < O; ++i) {
        const float send = up ? x[i] : x[i + O];
        const float keep = up ? x[i + O] : x[i];
        x[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
}

__device__ __forceinline__ void reduce_scatter(float (&x)[32], int lane)
{
    scatter_level<16>(x, lane);
    scatter_level<8>(x, lane);
    scatter_level<4>(x, lane);
    scatter_level<2>(x, lane);
    scatter_level<1>(x, lane);
}

__global__ void __launch_bounds__(PPT, 4) blend_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x,
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent
    float* __restrict__ dinst)         // (10, K)
{
    // [mx, my, ca, cb], [cc, op, r, g], [b, invz, -, -] per staged instance
    __shared__ float4 batch[3][BATCH];
    __shared__ float box[5][BATCH];  // x0, x1, y0, y1, tau_m
    // +1: the ten lanes of one instance write ten rows without bank conflicts
    __shared__ float partial[WARPS][N_GRAD][BATCH + 1];
    __shared__ unsigned long long wrote[WARPS];

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
    // the entry this lane holds after a reduce-scatter: instance g, row r
    const int my_g = lane / N_GRAD;
    const int my_r = lane - my_g * N_GRAD;

    const float* f = fwd + ((long long)t * PPT + pix) * 8;
    const float* d = dout + ((long long)t * PPT + pix) * 8;
    const float d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3];
    const float s_total = ((f[0] * d0 + f[1] * d1) + f[2] * d2) + f[3] * d3;
    const float bgdot = d[4] * f[4];

    float T = 1.0f, prefix = 0.0f;
    bool done = false;
    int b0 = s;

    for (; b0 < e; b0 += BATCH) {
        // also the barrier that lets the previous batch's readers finish
        if (__syncthreads_count(done) == PPT) break;
        const int nb = min(BATCH, e - b0);
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
        // the staged instances that reach this warp's pixels
        unsigned long long m = 0;
#pragma unroll
        for (int h = 0; h < BATCH / 32; ++h) {
            const int jl = h * 32 + lane;
            const int jr = jl < nb ? jl : 0;
            const float4 r0 = batch[0][jr];
            const float r4 = batch[1][jr].x;
            const unsigned bits = __ballot_sync(
                FULL, jl < nb && gs::reaches(r0.x, r0.y, r0.z, r0.w, r4, box[4][jl], box[0][jl],
                                             box[1][jl], box[2][jl], box[3][jl],
                                             wx0, wx1, wy0, wy1));
            m |= (unsigned long long)bits << (32 * h);
        }
        unsigned long long written = 0;
        while (m && !__all_sync(FULL, done)) {
            float x[32];
            int js[G];
            bool contrib_any = false;
#pragma unroll
            for (int i = 0; i < 32; ++i) x[i] = 0.0f;
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
                js[gi] = -1;
                if (!m) continue;
                const int j = __ffsll((long long)m) - 1;
                m &= m - 1;
                js[gi] = j;
                // predicated, not branched: the warp runs the pair whenever
                // one lane keeps it, and straight-line code lets the three
                // instances' loads, exp and reciprocal overlap; only T,
                // prefix and done carry from one to the next
                const float4 q0 = batch[0][j];
                const float4 q1 = batch[1][j];
                const float4 q2 = batch[2][j];
                const float ca = q0.z, cb = q0.w, cc = q1.x, op = q1.y;
                float dx, dy, power, g, alpha;
                const bool pass = gs::pair_power(q0.x, q0.y, ca, cb, cc, px, py, dx, dy, power);
                const bool keep = gs::pair_alpha(power, op, g, alpha) && pass && !done;
                const float test_t = T * (1.0f - alpha);
                const bool stop = keep && test_t < gs::T_EPS;
                const bool blend = keep && !stop;
                done = done || stop;
                const float c = ((q1.z * d0 + q1.w * d1) + q2.x * d2) + q2.y * d3;
                const float w = alpha * T;
                const float pre = prefix + w * c;
                const float suffix = s_total - pre;
                const float inv_one_m = 1.0f / (1.0f - alpha);
                const float dalpha = T * c - (suffix + bgdot) * inv_one_m;
                const float dgm = (op * dalpha) * g;
                const int o = gi * N_GRAD;  // a constant once unrolled
                x[o + 0] = blend ? dgm * ((ca + ca) * dx + cb * dy) : 0.0f;
                x[o + 1] = blend ? dgm * ((cc + cc) * dy + cb * dx) : 0.0f;
                x[o + 2] = blend ? -0.5f * (dgm * dx * dx) : 0.0f;
                x[o + 3] = blend ? -(dgm * dx * dy) : 0.0f;
                x[o + 4] = blend ? -0.5f * (dgm * dy * dy) : 0.0f;
                x[o + 5] = blend ? g * dalpha : 0.0f;
                x[o + 6] = blend ? w * d0 : 0.0f;
                x[o + 7] = blend ? w * d1 : 0.0f;
                x[o + 8] = blend ? w * d2 : 0.0f;
                x[o + 9] = blend ? w * d3 : 0.0f;
                contrib_any = contrib_any || blend;
                prefix = blend ? pre : prefix;
                T = blend ? test_t : T;
            }
            if (!__any_sync(FULL, contrib_any)) continue;
            reduce_scatter(x, lane);
            // js[] is warp-uniform; pick this lane's instance without
            // indexing the register array dynamically
            int jm = -1;
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
                if (my_g == gi) jm = js[gi];
                if (js[gi] >= 0) written |= 1ull << js[gi];
            }
            if (jm >= 0) partial[warp][my_r][jm] = x[0];
        }
        if (lane == 0) wrote[warp] = written;
        __syncthreads();
        for (int idx = tid; idx < N_GRAD * nb; idx += PPT) {
            const int r = idx / nb;
            const int j = idx - r * nb;
            float acc = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w)
                if ((wrote[w] >> j) & 1ull) acc += partial[w][r][j];
            dinst[r * k + b0 + j] = acc;
        }
    }
    // every pixel stopped before the range ended: the rest gets zero rows
    for (long long i = b0 + tid; i < e; i += PPT) {
#pragma unroll
        for (int r = 0; r < N_GRAD; ++r) dinst[r * k + i] = 0.0f;
    }
}

}  // namespace

extern "C" int gs_blend_bwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, const void* fwd, const void* dout, void* dinst,
    void* stream)
{
    blend_bwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        grid_x, (const float*)fwd, (const float*)dout, (float*)dinst);
    return (int)cudaGetLastError();
}
