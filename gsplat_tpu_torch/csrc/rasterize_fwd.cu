// Kernel K2': the sorted front-to-back forward blend, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel` of gsplat_tpu/ops/rasterize_pallas.py
// (:368; per-chunk math `_chunk_blend`, :184-242), launched by `_run_forward`
// from `blend_tiles_pallas`. The TPU kernel lays pixels on sublanes and
// gaussians on lanes and turns the transmittance recurrence into a lane
// cumprod. Here the shape is the CUDA reference's (`forward.cu:277-400`):
// one block of 256 threads per 16x16 tile, one thread per pixel, each pixel
// walking its tile's sorted [start, end) range in order.
//
// Bound on the card: operations. Each evaluated (pixel, instance) pair costs
// ~25 float32 operations including one expf, against 40 bytes per instance
// read once per tile from device memory and amortized over 256 pixels.
// Staging is a quarter of the time (the skeleton P1'); the rest is pair
// math, and most walked pairs fail the keep test: a small gaussian binned
// to a tile reaches few of its pixels.
//
// Design:
// - The block walks the range in batches of 256 instances. Each thread
//   stages one instance as three float4 (so a pair reads it with three
//   shared loads, not ten) and its pixel box and margin-padded tau
//   (`gs::pixel_box`).
// - The warp cull (`gs::reaches`, common.cuh): a warp owns an 8x4 block of
//   the tile (`gs::warp_pixel`; 8x4 blocks cull more (warp, instance) pairs
//   than 16x2 strips) and, per 32 staged instances, one ballot of the box
//   and conic-minimum test against its rectangle gives the instances it
//   walks. The rest cannot be kept at any of its pixels; the test is
//   warp-uniform and touches no pixel state, so the output is bit for bit
//   the walk over every instance.
// - Each walked pair is predicated, not branched: the warp runs it whenever
//   one lane keeps it, and straight-line code overlaps one instance's loads
//   and exp with the previous one's T update.
// - A warp whose pixels all stopped leaves the batch; the block stops once
//   all its pixels are done (`__syncthreads_count`).
// Later work: balance tiles of very different range lengths across SMs.
// Copying the next batch with cp.async during the walk was tried and did
// not pay: six resident blocks per SM already hide one block's staging.
//
// Semantics, equal to the TPU kernel's (rasterize_pallas.py:184-242, 368-493):
//   power, alpha and keep as `gs::pair_power` and `gs::pair_alpha`
//     (common.cuh) compute them, the one definition the backward K3' shares;
//   the pixel stops when T * (1 - alpha) < 1e-4, and that gaussian is not
//     blended; final_T is the T of the blended prefix;
//   invdepth = sum of w * invz; n_contrib = 1-based position of the last
//     blended instance in the range (0 unless track_contrib);
//   empty tiles give color 0 and final_T 1.
// Output (T, 256, 8) float32: [r, g, b, invdepth, final_T, n_contrib, 0, 0],
// indexed by pixel (row-major in the tile) whatever warp owns it.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;
using gs::TILE;

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PPT) blend_fwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x, int track_contrib,
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

    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, inv = 0.0f;
    int last = 0;
    bool done = false;

    for (int b0 = s; b0 < e; b0 += PPT) {
        // also the barrier that lets the previous batch's readers finish
        if (__syncthreads_count(done) == PPT) break;
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
                // one lane keeps it, and straight-line code overlaps the
                // next instance's loads and exp with this one's T update
                const float4 q0 = batch[0][j];
                const float4 q1 = batch[1][j];
                const float4 q2 = batch[2][j];
                float dx, dy, power, g, alpha;
                const bool pass = gs::pair_power(q0.x, q0.y, q0.z, q0.w, q1.x, px, py,
                                                 dx, dy, power);
                const bool keep = gs::pair_alpha(power, q1.y, g, alpha) && pass && !done;
                const float test_t = T * (1.0f - alpha);
                const bool stop = keep && test_t < gs::T_EPS;
                const bool blend = keep && !stop;
                done = done || stop;
                const float w = alpha * T;
                c0 = blend ? c0 + q1.z * w : c0;
                c1 = blend ? c1 + q1.w * w : c1;
                c2 = blend ? c2 + q2.x * w : c2;
                inv = blend ? inv + q2.y * w : inv;
                T = blend ? test_t : T;
                last = blend ? b0 - s + j + 1 : last;
            }
            if (__all_sync(FULL, done)) break;
        }
    }

    float* o = out + ((long long)t * PPT + pix) * 8;
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
    o[3] = inv;
    o[4] = T;
    o[5] = track_contrib ? (float)last : 0.0f;
    o[6] = 0.0f;
    o[7] = 0.0f;
}

}  // namespace

extern "C" int gs_blend_fwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, int track_contrib, void* out, void* stream)
{
    blend_fwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        grid_x, track_contrib, (float*)out);
    return (int)cudaGetLastError();
}
