// The photometric loss, (1 - lambda) L1 + lambda (1 - SSIM), forward and
// backward, on Hopper (sm_90a).
//
// Counterpart of the JAX package's `ssim` with its custom VJP (`_ssim_fwd`,
// `_ssim_bwd`, gsplat_tpu/train/losses.py:88-148) and `l1_loss`, as
// `photometric_loss` (:151) combines them. None of them has a Pallas kernel:
// XLA fuses the separable blurs and the elementwise work under `jit`. Eager
// PyTorch ran the forward as five blurs of two depthwise cuDNN convolutions
// each and ~60 elementwise launches, the backward as six more blurs (three of
// them for the ground truth's gradient, which training never reads), each a
// full pass over the image in device memory.
//
// `gs_loss_fwd`: one block per 16 x 16 output tile, all three channels. The
// block stages both images' tile with a 5-pixel halo on every side (26 x 26
// pixels, zeros outside the image: the blur's "same" zero padding) in shared
// memory, blurs x, y, x^2, y^2 and xy along H into a second shared tile
// (16 x 26 pixels), then along W per output pixel, each sum in tap order
// 0..10 starting from tap 0's product, as the twin `_blur` writes it. From
// the five blurs it forms the SSIM map and, where a gradient is wanted, the
// three partials of `_ssim_partials` (d mu, d blur(x^2), d blur(xy)) for the
// rendered image (and, only when asked for, for the ground truth), written as
// (3, H, W, 3) maps. Each block sums its SSIM map and |x - y| in a fixed
// order (per thread, then a warp-shuffle tree); a second one-block kernel
// (`loss_fwd_kernel_finish`) adds the block sums in double, in a fixed
// order, and writes the loss, the L1 mean and the SSIM mean.
//
// `gs_loss_bwd`: one block per 16 x 16 tile. It stages the three partial
// maps with the halo, blurs them (the window is symmetric and the padding
// zero, so the blur is its own transpose: losses.py:101) and forms
//   g = a sign(x - y) + b (blur(d mu) + 2 x blur(d p) + y blur(d q)),
//   a = ((1 - lambda) g_loss + g_l1) / n,  b = (g_ssim - lambda g_loss) / n,
// the incoming gradients read from device memory (a NULL one is 0), so no
// value crosses to the host. Called with the images swapped and the ground
// truth's partials, it forms the ground truth's gradient, which the train
// step never asks for.
//
// Float32 throughout, built with -fmad=false and without fast math: SSIM's
// blur(x^2) - mu^2 cancels almost exactly (gsplat_tpu/train/losses.py:39-48),
// and every operation rounds once as torch's CUDA kernels do, so the partial
// maps and the gradient equal the plain twins' (`loss_fwd_torch`,
// `loss_bwd_torch`, train/losses.py) bit for bit on the card. The twin sums
// the two means in this file's order (`_kernel_order_mean`), so they and
// the loss are equal too.
//
// Bound on the card: bytes. The forward reads two H x W x 3 images and
// writes three partial maps; the backward reads the three maps and both
// images and writes the gradient. About 260 (forward) and 150 (backward)
// float operations per value stay under the FP32 rate's share of that time.
// The halo makes each block read (26/16)^2 = 2.6 times its tile, from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LOSS_TAPS 11

struct LossFwdArgs {
    const float* x;      // (H, W, 3) the rendered image
    const float* y;      // (H, W, 3) the ground truth
    float* px;           // (3, H, W, 3) x-side partials, or NULL
    float* py;           // (3, H, W, 3) y-side partials, or NULL
    float* block_sums;   // (2, blocks): SSIM map, |x - y|
    float* loss;         // ()
    float* l1;           // ()
    float* ssim;         // ()
    int h, w;
    float taps[LOSS_TAPS];
    float c1, c2, lam, olam;  // C1, C2, lambda, 1 - lambda
};

struct LossBwdArgs {
    const float* a;         // (H, W, 3) the image whose gradient is formed
    const float* b;         // (H, W, 3) the other image
    const float* partials;  // (3, H, W, 3) a's side: d mu, d p, d q
    const float* g_loss;    // () or NULL
    const float* g_l1;      // () or NULL
    const float* g_ssim;    // () or NULL
    float* grad;            // (H, W, 3)
    int h, w;
    float taps[LOSS_TAPS];
    float lam, olam, inv_n;
};

namespace {

constexpr int C = 3;
constexpr int HALO = LOSS_TAPS / 2;
constexpr int TILE = 16;
constexpr int REG = TILE + 2 * HALO;  // 26: the tile with its halo
constexpr int ROWF = REG * C;         // floats of one staged row
constexpr int THREADS = TILE * TILE;
constexpr int FINISH_THREADS = 1024;

// stage rows [y0 - HALO, y0 + TILE + HALO) and columns [x0 - HALO, x0 + TILE
// + HALO) of an (H, W, 3) map, zeros outside the image
__device__ __forceinline__ void stage(float (*dst)[ROWF], const float* __restrict__ src, int h,
                                      int w, int x0, int y0)
{
    for (int i = threadIdx.x; i < REG * ROWF; i += THREADS) {
        const int r = i / ROWF, k = i - r * ROWF;
        const int gy = y0 - HALO + r, gx = x0 - HALO + k / C;
        float val = 0.0f;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w)
            val = src[((long long)gy * w + (x0 - HALO)) * C + k];
        dst[r][k] = val;
    }
}

struct Partials {
    float d_mu, d_p, d_q;
};

// `_ssim_partials(mu1, mu2, s1, s2, s12)`, operation for operation
__device__ __forceinline__ Partials ssim_partials(float mu1, float mu2, float s1, float s2,
                                                  float s12, float c1, float c2)
{
    const float A = 2.0f * mu1 * mu2 + c1;
    const float B = 2.0f * s12 + c2;
    const float Cc = mu1 * mu1 + mu2 * mu2 + c1;
    const float D = s1 + s2 + c2;
    const float inv_CD = 1.0f / (Cc * D);
    const float AB_CD = A * B * inv_CD;
    Partials out;
    out.d_q = 2.0f * A * inv_CD;
    out.d_p = -AB_CD / D;
    out.d_mu = 2.0f * mu2 * B * inv_CD - 2.0f * mu1 * AB_CD / Cc + 2.0f * mu1 * AB_CD / D
               - mu2 * out.d_q;
    return out;
}

__device__ __forceinline__ float block_sum(float v, float* scratch)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // scratch may still be read by an earlier call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float s = 0.0f;
    if (threadIdx.x == 0)
        for (int i = 0; i < THREADS / 32; ++i) s += scratch[i];
    return s;
}

__global__ void __launch_bounds__(THREADS) loss_fwd_kernel(const LossFwdArgs a)
{
    __shared__ float sx[REG][ROWF], sy[REG][ROWF];
    __shared__ float sh[5][TILE][ROWF];  // blurred along H: x, y, x^2, y^2, xy
    __shared__ float scratch[THREADS / 32];

    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    stage(sx, a.x, a.h, a.w, x0, y0);
    stage(sy, a.y, a.h, a.w, x0, y0);
    __syncthreads();

    for (int i = threadIdx.x; i < TILE * ROWF; i += THREADS) {
        const int r = i / ROWF, k = i - r * ROWF;
        float xv = sx[r][k], yv = sy[r][k];
        float s0 = a.taps[0] * xv, s1 = a.taps[0] * yv, s2 = a.taps[0] * (xv * xv),
              s3 = a.taps[0] * (yv * yv), s4 = a.taps[0] * (xv * yv);
#pragma unroll
        for (int t = 1; t < LOSS_TAPS; ++t) {
            xv = sx[r + t][k];
            yv = sy[r + t][k];
            s0 = s0 + a.taps[t] * xv;
            s1 = s1 + a.taps[t] * yv;
            s2 = s2 + a.taps[t] * (xv * xv);
            s3 = s3 + a.taps[t] * (yv * yv);
            s4 = s4 + a.taps[t] * (xv * yv);
        }
        sh[0][r][k] = s0;
        sh[1][r][k] = s1;
        sh[2][r][k] = s2;
        sh[3][r][k] = s3;
        sh[4][r][k] = s4;
    }
    __syncthreads();

    const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
    const int py = y0 + ly, px = x0 + lx;
    float map_sum = 0.0f, l1_sum = 0.0f;
    if (py < a.h && px < a.w) {
        const long long hwc = (long long)a.h * a.w * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float b[5];
#pragma unroll
            for (int q = 0; q < 5; ++q) {
                float s = a.taps[0] * sh[q][ly][lx * C + c];
#pragma unroll
                for (int t = 1; t < LOSS_TAPS; ++t) s = s + a.taps[t] * sh[q][ly][(lx + t) * C + c];
                b[q] = s;
            }
            const float mu1 = b[0], mu2 = b[1];
            const float s1 = b[2] - mu1 * mu1;
            const float s2 = b[3] - mu2 * mu2;
            const float s12 = b[4] - mu1 * mu2;
            const float map = ((2.0f * mu1 * mu2 + a.c1) * (2.0f * s12 + a.c2))
                              / ((mu1 * mu1 + mu2 * mu2 + a.c1) * (s1 + s2 + a.c2));
            const float xv = sx[ly + HALO][(lx + HALO) * C + c];
            const float yv = sy[ly + HALO][(lx + HALO) * C + c];
            map_sum += map;
            l1_sum += fabsf(xv - yv);
            const long long o = ((long long)py * a.w + px) * C + c;
            if (a.px) {
                const Partials d = ssim_partials(mu1, mu2, s1, s2, s12, a.c1, a.c2);
                a.px[o] = d.d_mu;
                a.px[hwc + o] = d.d_p;
                a.px[2 * hwc + o] = d.d_q;
            }
            if (a.py) {
                const Partials d = ssim_partials(mu2, mu1, s2, s1, s12, a.c1, a.c2);
                a.py[o] = d.d_mu;
                a.py[hwc + o] = d.d_p;
                a.py[2 * hwc + o] = d.d_q;
            }
        }
    }
    const int blocks = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    const float ms = block_sum(map_sum, scratch);
    const float ls = block_sum(l1_sum, scratch);
    if (threadIdx.x == 0) {
        a.block_sums[blk] = ms;
        a.block_sums[blocks + blk] = ls;
    }
}

__global__ void __launch_bounds__(FINISH_THREADS) loss_fwd_kernel_finish(const LossFwdArgs a,
                                                                         int blocks)
{
    __shared__ double s_map[FINISH_THREADS], s_l1[FINISH_THREADS];
    double m = 0.0, l = 0.0;
    for (int i = threadIdx.x; i < blocks; i += FINISH_THREADS) {
        m += (double)a.block_sums[i];
        l += (double)a.block_sums[blocks + i];
    }
    s_map[threadIdx.x] = m;
    s_l1[threadIdx.x] = l;
    __syncthreads();
    for (int half = FINISH_THREADS / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
            s_map[threadIdx.x] += s_map[threadIdx.x + half];
            s_l1[threadIdx.x] += s_l1[threadIdx.x + half];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        const double n = (double)a.h * a.w * C;
        const float l1 = (float)(s_l1[0] / n);
        const float ss = (float)(s_map[0] / n);
        *a.l1 = l1;
        *a.ssim = ss;
        *a.loss = a.olam * l1 + a.lam * (1.0f - ss);
    }
}

__global__ void __launch_bounds__(THREADS) loss_bwd_kernel(const LossBwdArgs a)
{
    __shared__ float sp[3][REG][ROWF];  // d mu, d p, d q with the halo
    __shared__ float sh[3][TILE][ROWF];  // blurred along H

    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    const long long hwc = (long long)a.h * a.w * C;
#pragma unroll
    for (int q = 0; q < 3; ++q) stage(sp[q], a.partials + q * hwc, a.h, a.w, x0, y0);
    __syncthreads();

    for (int i = threadIdx.x; i < TILE * ROWF; i += THREADS) {
        const int r = i / ROWF, k = i - r * ROWF;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            float s = a.taps[0] * sp[q][r][k];
#pragma unroll
            for (int t = 1; t < LOSS_TAPS; ++t) s = s + a.taps[t] * sp[q][r + t][k];
            sh[q][r][k] = s;
        }
    }
    __syncthreads();

    const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
    const int py = y0 + ly, px = x0 + lx;
    if (py >= a.h || px >= a.w) return;
    const float gl = a.g_loss ? *a.g_loss : 0.0f;
    const float g1 = a.g_l1 ? *a.g_l1 : 0.0f;
    const float gs = a.g_ssim ? *a.g_ssim : 0.0f;
    const float ca = (a.olam * gl + g1) * a.inv_n;
    const float cb = (gs - a.lam * gl) * a.inv_n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float bl[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            float s = a.taps[0] * sh[q][ly][lx * C + c];
#pragma unroll
            for (int t = 1; t < LOSS_TAPS; ++t) s = s + a.taps[t] * sh[q][ly][(lx + t) * C + c];
            bl[q] = s;
        }
        const long long o = ((long long)py * a.w + px) * C + c;
        const float av = a.a[o], bv = a.b[o];
        const float d = av - bv;
        const float sign = (float)((0.0f < d) - (d < 0.0f));  // torch.sign
        a.grad[o] = ca * sign + cb * (bl[0] + 2.0f * av * bl[1] + bv * bl[2]);
    }
}

}  // namespace

extern "C" int gs_loss_fwd(const LossFwdArgs* a, void* stream)
{
    if (a->h <= 0 || a->w <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((a->w + TILE - 1) / TILE, (a->h + TILE - 1) / TILE);
    cudaStream_t st = (cudaStream_t)stream;
    loss_fwd_kernel<<<grid, THREADS, 0, st>>>(*a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    loss_fwd_kernel_finish<<<1, FINISH_THREADS, 0, st>>>(*a, (int)(grid.x * grid.y));
    return (int)cudaGetLastError();
}

extern "C" int gs_loss_bwd(const LossBwdArgs* a, void* stream)
{
    if (a->h <= 0 || a->w <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((a->w + TILE - 1) / TILE, (a->h + TILE - 1) / TILE);
    loss_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
