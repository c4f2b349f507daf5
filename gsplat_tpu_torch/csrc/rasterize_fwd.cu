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
// Staging: the block walks the range in batches of 256 instances; each thread
// copies one instance's 10 floats into shared memory (10 KB per block), then
// every pixel walks the batch. The block stops once all its pixels are done
// (`__syncthreads_count`).
//
// Bound on the card: operations. Each evaluated (pixel, instance) pair costs
// ~25 float32 operations including one expf, against 40 bytes per instance
// read once per tile from device memory and amortized over 256 pixels. The
// design keeps the instance stream in shared memory, so the inner loop reads
// no device memory; what it does not yet do (later work) is overlap the next
// batch's loads with this batch's walk, or balance tiles of very different
// range lengths across SMs.
//
// Semantics, equal to the TPU kernel's (rasterize_pallas.py:184-242, 368-493):
//   power, alpha and keep as `gs::pair_power` and `gs::pair_alpha`
//     (common.cuh) compute them, the one definition the backward K3' shares;
//   the pixel stops when T * (1 - alpha) < 1e-4, and that gaussian is not
//     blended; final_T is the T of the blended prefix;
//   invdepth = sum of w * invz; n_contrib = 1-based position of the last
//     blended instance in the range (0 unless track_contrib);
//   empty tiles give color 0 and final_T 1.
// Output (T, 256, 8) float32: [r, g, b, invdepth, final_T, n_contrib, 0, 0].

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;
using gs::TILE;

__global__ void __launch_bounds__(PPT) blend_fwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x, int track_contrib,
    float* __restrict__ out)           // (T, 256, 8)
{
    __shared__ float batch[N_ATTR][PPT];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const float px = (float)((t % grid_x) * TILE + tid % TILE);
    const float py = (float)((t / grid_x) * TILE + tid / TILE);
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
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) batch[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        for (int j = 0; j < nb && !done; ++j) {
            float dx, dy, power, g, alpha;
            if (!gs::pair_power(batch[0][j], batch[1][j], batch[2][j], batch[3][j],
                                batch[4][j], px, py, dx, dy, power)
                || !gs::pair_alpha(power, batch[5][j], g, alpha))
                continue;
            const float test_t = T * (1.0f - alpha);
            if (test_t < gs::T_EPS) {
                done = true;
                break;
            }
            const float w = alpha * T;
            c0 += batch[6][j] * w;
            c1 += batch[7][j] * w;
            c2 += batch[8][j] * w;
            inv += batch[9][j] * w;
            T = test_t;
            last = b0 - s + j + 1;
        }
    }

    float* o = out + ((long long)t * PPT + tid) * 8;
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
