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
// Each row is a sum over the tile's 256 pixels. The block stages 64
// instances at a time in shared memory; for each, a warp that has any
// contributing pixel reduces its 32 lanes' ten terms by shuffles (a warp
// with none writes zeros without shuffling), and after the batch the block
// sums the 8 warps' partials per (row, instance) and writes them coalesced.
// Each instance slot belongs to exactly one tile, so every output column is
// written once, by its tile's block, with no atomics. Instances past the
// point where every pixel of the tile has stopped get zero rows.
//
// Bound on the card: operations. Every evaluated (pixel, instance) pair
// redoes the forward's ~11 operations before the keep test, and every
// blended pair adds ~45 for the gradient terms, against 40 bytes per
// instance read and 40 written once. What the design does not do yet
// (later work): skip the shuffles of warps whose pixels all stopped, fuse
// the per-gaussian reduce (K4') into the epilogue with atomics, overlap
// staging with the walk, balance tiles of very different lengths.
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

__global__ void __launch_bounds__(PPT) blend_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x,
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent
    float* __restrict__ dinst)         // (10, K)
{
    __shared__ float batch[N_ATTR][BATCH];
    __shared__ float partial[WARPS][N_GRAD][BATCH];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float px = (float)((t % grid_x) * TILE + tid % TILE);
    const float py = (float)((t / grid_x) * TILE + tid / TILE);
    const int s = tile_start[t];
    const int e = tile_end[t];

    const float* f = fwd + ((long long)t * PPT + tid) * 8;
    const float* d = dout + ((long long)t * PPT + tid) * 8;
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
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) batch[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
            float v[N_GRAD];
            bool contrib = false;
            float dx, dy, power, g, alpha;
            if (!done
                && gs::pair_power(batch[0][j], batch[1][j], batch[2][j], batch[3][j],
                                  batch[4][j], px, py, dx, dy, power)
                && gs::pair_alpha(power, batch[5][j], g, alpha)) {
                const float test_t = T * (1.0f - alpha);
                if (test_t < gs::T_EPS) {
                    done = true;
                } else {
                    contrib = true;
                    const float c = ((batch[6][j] * d0 + batch[7][j] * d1)
                                     + batch[8][j] * d2) + batch[9][j] * d3;
                    const float w = alpha * T;
                    prefix += w * c;
                    const float suffix = s_total - prefix;
                    const float inv_one_m = 1.0f / (1.0f - alpha);
                    const float dalpha = T * c - (suffix + bgdot) * inv_one_m;
                    const float dgm = (batch[5][j] * dalpha) * g;
                    const float ca = batch[2][j], cb = batch[3][j], cc = batch[4][j];
                    v[0] = dgm * ((ca + ca) * dx + cb * dy);
                    v[1] = dgm * ((cc + cc) * dy + cb * dx);
                    v[2] = -0.5f * (dgm * dx * dx);
                    v[3] = -(dgm * dx * dy);
                    v[4] = -0.5f * (dgm * dy * dy);
                    v[5] = g * dalpha;
                    v[6] = w * d0;
                    v[7] = w * d1;
                    v[8] = w * d2;
                    v[9] = w * d3;
                    T = test_t;
                }
            }
            if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
                for (int r = 0; r < N_GRAD; ++r) {
                    float x = contrib ? v[r] : 0.0f;
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        x += __shfl_xor_sync(0xffffffffu, x, off);
                    if (lane == 0) partial[warp][r][j] = x;
                }
            } else if (lane == 0) {
#pragma unroll
                for (int r = 0; r < N_GRAD; ++r) partial[warp][r][j] = 0.0f;
            }
        }
        __syncthreads();
        for (int idx = tid; idx < N_GRAD * nb; idx += PPT) {
            const int r = idx / nb;
            const int j = idx - r * nb;
            float acc = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) acc += partial[w][r][j];
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
