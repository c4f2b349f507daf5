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
// `gs_loss_fwd`, one launch: a block of 256 threads per 64 x 16 output
// tile (one row of the twin's 16 x 16 tiles of the means), all three
// channels, two blocks per SM (98,308 bytes of shared memory each):
//   - the blur along H, once per tile: a thread owns one float column
//     (pixel and channel) of the tile's 74-pixel span and walks down its 26
//     rows, reading x and y straight from device memory into registers
//     (zeros outside the image: the blur's "same" zero padding; a warp
//     reads 128 contiguous bytes), forming x^2, y^2 and xy once per value
//     and adding each into the output rows it reaches, into per-channel
//     planes in shared memory;
//   - then, with no barrier but the warp's own, a warp per two output rows
//     (one warp slot of each 16 x 16 group), a lane per two adjacent
//     pixels: per channel and field the blur along W from a register window
//     of the 12 values its two outputs reach (six 8-byte loads), the SSIM
//     map and, where a gradient is wanted, the three partials of
//     `_ssim_partials` (d mu, d blur(x^2), d blur(xy)) of the rendered
//     image (and, only when asked for, of the ground truth: a second
//     instantiation), which go through the warp's rows in shared memory to
//     16-byte stores along each row of the (3, H, W, 3) maps;
// every sum in tap order 0..10 starting from tap 0's product, as the twin
// `_blur` writes it, with no contraction (-fmad=false), so the values equal
// the twin's bit for bit. The means are summed in the twin's order
// (`_kernel_order_mean`): each pixel's three channels in order, a warp's
// 32-lane shuffle-down tree over its two rows of each group, the group's 8
// warp sums in order, into one slot per 16 x 16 group. The last block to
// finish (an atomic ticket on a counter the wrapper keeps zeroed; that
// block zeroes it again) adds the slots in double, slot i into lane i mod
// 1024, then the 1024 lanes halved pairwise, and writes the loss, the L1
// mean and the SSIM mean.
//
// `gs_loss_bwd`: a block per 64 x 24 tile, two per SM (82,752 bytes). It
// blurs the three partial maps along H once per tile in the same way (34
// rows a column), then a warp per row blurs them along W; the row writer
// reads both images with 16-byte loads issued before the blur and forms
//   g = a sign(x - y) + b (blur(d mu) + 2 x blur(d p) + y blur(d q)),
//   a = ((1 - lambda) g_loss + g_l1) / n,  b = (g_ssim - lambda g_loss) / n,
// written with 16-byte stores (the window is symmetric and the padding
// zero, so the blur is its own transpose: losses.py:101). The incoming
// gradients are read from device memory (a NULL one is 0), so no value
// crosses to the host. Called with the images swapped and the ground
// truth's partials, it forms the ground truth's gradient, which the train
// step never asks for.
//
// Float32 throughout, built with -fmad=false and without fast math: SSIM's
// blur(x^2) - mu^2 cancels almost exactly (gsplat_tpu/train/losses.py:39-48),
// and every operation rounds once as torch's CUDA kernels do, so the partial
// maps, the gradient and the means equal the plain twins' (`loss_fwd_torch`,
// `loss_bwd_torch`, train/losses.py) bit for bit on the card.
//
// Bound on the card: bytes, and for the forward the issue of its ~280
// separate float multiplies and adds per value (no contraction: the float32
// pipe issues 33.5e12 a second, 0.052 ms at 1080p), above its byte bound.
// The halo makes the blur along H read 1.88 (forward) and 1.64 (backward)
// times the tile, the part past the tile from L2. Staging the tile in
// shared memory first (16-byte asynchronous copies) left each block's
// loads and its arithmetic in two phases that did not overlap; loading
// into the walking thread's registers keeps the loads in flight beside
// the other block's work (`scripts/loss_ablate.py` splits the time).

#include <cuda_runtime.h>
#include <atomic>
#include <math.h>
#include <stdint.h>

#define LOSS_TAPS 11

struct LossFwdArgs {
    const float* x;        // (H, W, 3) the rendered image
    const float* y;        // (H, W, 3) the ground truth
    float* px;             // (3, H, W, 3) x-side partials, or NULL
    float* py;             // (3, H, W, 3) y-side partials, or NULL
    float* block_sums;     // (2, tiles): SSIM map, |x - y| per 16 x 16 tile
    float* loss;           // ()
    float* l1;             // ()
    float* ssim;           // ()
    unsigned int* ticket;  // () zero before the launch, zero after it
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

// the kernels' shared memory, carved per kernel
extern __shared__ __align__(16) float loss_smem[];

namespace {

constexpr int C = 3;
constexpr int HALO = LOSS_TAPS / 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 64;                     // output tile width, pixels: a lane per pixel pair
constexpr int GROUP = 16;                  // the means' tile (the twin's `_TILE`)
constexpr int FWD_TH = GROUP, BWD_TH = 24;  // output tile heights
constexpr int SPAN = TW + 2 * HALO;        // 74 pixels of the tile and its halo per row
constexpr int SPAN_F = SPAN * C;           // 222 floats: a thread each in the blur along H
constexpr int OUT_ROW = TW * C + 4;        // an output row from its 16-byte boundary
constexpr int FINISH = 1024;               // lanes of the means' double sum
constexpr int FWD_GX = TW / GROUP;         // 16 x 16 groups per forward tile
constexpr int SLOTS = GROUP * GROUP / 32;  // warp sums per group: two group rows each
static_assert(TW == 2 * 32 && SPAN_F <= THREADS, "a lane per pixel pair, a thread per column");
static_assert(FWD_TH == 2 * WARPS, "a warp per two forward rows: one warp slot of each group");

// shared memory, in floats: the blur along H of the tile (fields x C
// planes of TH x SPAN), then each warp's writer rows ([3][OUT_ROW]); the
// forward also each warp's pixel sums ([2][2 rows][TW]), the warp sums and
// the last-block flag
constexpr int FWD_HB = 5 * C * FWD_TH * SPAN;
constexpr int FWD_SMEM = (FWD_HB + WARPS * (3 * OUT_ROW + 4 * TW) + 2 * FWD_GX * SLOTS + 1) * 4;
constexpr int BWD_HB = 3 * C * BWD_TH * SPAN;
constexpr int BWD_SMEM = (BWD_HB + WARPS * 3 * OUT_ROW) * 4;
static_assert(2 * FINISH * 2 <= FWD_HB, "the finish's doubles fit the H pass's planes");

// how far float `f` of the buffer at `base` lies past a 16-byte boundary
__device__ __forceinline__ int misalign(const float* base, long long f)
{
    return (int)(((long long)((uintptr_t)base >> 2) + f) & 3);
}

__device__ __forceinline__ float4 load4(const float* p) { return *(const float4*)p; }

__device__ __forceinline__ void store4(float* p, float4 v) { *(float4*)p = v; }

// 16 bytes of a row at float `b` (16-byte aligned where `vec`), zeros
// outside floats [lo, hi)
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ src, long long b,
                                             long long lo, long long hi, bool vec)
{
    if (vec && b >= lo && b + 4 <= hi) return load4(src + b);
    float4 v;
    v.x = b >= lo && b < hi ? src[b] : 0.0f;
    v.y = b + 1 >= lo && b + 1 < hi ? src[b + 1] : 0.0f;
    v.z = b + 2 >= lo && b + 2 < hi ? src[b + 2] : 0.0f;
    v.w = b + 3 >= lo && b + 3 < hi ? src[b + 3] : 0.0f;
    return v;
}

// Write floats [f0, f0 + n) of `dst` from `row`, whose float k sits at
// `misalign(dst, f0) + k`: 16-byte stores, single floats at the ends. A
// warp per row.
__device__ __forceinline__ void write_row(float* __restrict__ dst, long long f0, int n,
                                          const float* row)
{
    const int lane = threadIdx.x & 31;
    const int sh = misalign(dst, f0);
    const long long a0 = f0 - sh;
    for (int j = lane; 4 * j < sh + n; j += 32) {
        const long long b = a0 + 4 * j;
        const float4 v = load4(row + 4 * j);
        if (b >= f0 && b + 4 <= f0 + n) {
            store4(dst + b, v);
        } else {
            if (b >= f0 && b < f0 + n) dst[b] = v.x;
            if (b + 1 >= f0 && b + 1 < f0 + n) dst[b + 1] = v.y;
            if (b + 2 >= f0 && b + 2 < f0 + n) dst[b + 2] = v.z;
            if (b + 3 >= f0 && b + 3 < f0 + n) dst[b + 3] = v.w;
        }
    }
}

// The blur along H of OUT output rows for NF fields, each a function of NS
// maps' values at one float: a thread per float column of the span (its
// pixel and channel fixed) walks the OUT + 10 rows it needs, read straight
// from device memory into registers (zeros outside the image), and adds
// each field into the output rows it reaches, tap t = row - output row, in
// tap order from tap 0's product; an output row leaves the registers once
// its last tap is in. Output plane (field q, channel c), row o, pixel p at
// hb[(q C + c) OUT SPAN + o SPAN + p].
template <int NF, int NS, int OUT, typename Fields>
__device__ __forceinline__ void blur_h(float* hb, const float* const (&src)[NS], int h, int w,
                                       int x0, int gy0, const float (&taps)[LOSS_TAPS],
                                       Fields fields)
{
    const int k = threadIdx.x;
    if (k >= SPAN_F) return;
    const int p = k / C, c = k - p * C;
    const int gx = x0 - HALO + p;
    const bool col = gx >= 0 && gx < w;
    float acc[OUT][NF];
#pragma unroll
    for (int i = 0; i < OUT + 2 * HALO; ++i) {
        const int gy = gy0 + i;
        const bool in = col && gy >= 0 && gy < h;
        const long long off = ((long long)gy * w + gx) * C + c;
        float v[NS], f[NF];
#pragma unroll
        for (int s = 0; s < NS; ++s) v[s] = in ? __ldg(src[s] + off) : 0.0f;
        fields(v, f);
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
            const int t = i - o;
            if (t == 0) {
#pragma unroll
                for (int q = 0; q < NF; ++q) acc[o][q] = taps[0] * f[q];
            } else if (t > 0 && t < LOSS_TAPS) {
#pragma unroll
                for (int q = 0; q < NF; ++q) acc[o][q] = acc[o][q] + taps[t] * f[q];
            }
            if (t == LOSS_TAPS - 1) {
#pragma unroll
                for (int q = 0; q < NF; ++q) hb[((q * C + c) * OUT + o) * SPAN + p] = acc[o][q];
            }
        }
    }
}

// The blur along W of one field and channel for a lane's two pixels (row
// `o`, pixels 2 lane and 2 lane + 1 of the tile): the 12 values
// they reach as a register window, each sum in tap order from tap 0's
// product.
__device__ __forceinline__ void blur_w(const float* plane, int o, const float (&taps)[LOSS_TAPS],
                                       float (&out)[2])
{
    const int lane = threadIdx.x & 31;
    const float* src = plane + o * SPAN + 2 * lane;
    float win[12];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
        const float2 v = *(const float2*)(src + 2 * m);
        win[2 * m] = v.x;
        win[2 * m + 1] = v.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        float s = taps[0] * win[e];
#pragma unroll
        for (int t = 1; t < LOSS_TAPS; ++t) s = s + taps[t] * win[e + t];
        out[e] = s;
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

// a lane's values of its two pixels, three channels, into its warp's
// writer rows (map m at rows[m OUT_ROW], shifted as the map's row in `dst`,
// maps hwc floats apart, starts at float f0)
template <int M>
__device__ __forceinline__ void put_rows(float* rows, const float (&v)[M][2][C], const float* dst,
                                         long long hwc, long long f0)
{
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        float* row = rows + m * OUT_ROW + misalign(dst, m * hwc + f0);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int c = 0; c < C; ++c) row[(2 * lane + e) * C + c] = v[m][e][c];
    }
}

// PY: the ground truth's partials are wanted too (never in training)
template <bool PY>
__global__ void __launch_bounds__(THREADS, 2) loss_fwd_kernel(const LossFwdArgs a)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* hb = loss_smem;                             // [5 C][FWD_TH][SPAN]: the blur along H
    float* orows = hb + FWD_HB + warp * 3 * OUT_ROW;  // this warp's [3][OUT_ROW]
    float* psum = hb + FWD_HB + WARPS * 3 * OUT_ROW + warp * 2 * 2 * TW;  // [2][2 rows][TW]
    float* wsum = hb + FWD_HB + WARPS * (3 * OUT_ROW + 4 * TW);  // [2][FWD_GX][SLOTS]
    int* last = (int*)(wsum + 2 * FWD_GX * SLOTS);

    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * FWD_TH;
    const long long hwc = (long long)a.h * a.w * C;
    const int n_out = (a.w - x0 < TW ? a.w - x0 : TW) * C;
    const float* const xy[2] = {a.x, a.y};

    // the blur along H of the whole tile, once
    blur_h<5, 2, FWD_TH>(hb, xy, a.h, a.w, x0, y0 - HALO, a.taps,
                         [](const float (&v)[2], float (&f)[5]) {
                             f[0] = v[0];
                             f[1] = v[1];
                             f[2] = v[0] * v[0];
                             f[3] = v[1] * v[1];
                             f[4] = v[0] * v[1];
                         });
    __syncthreads();

    // then a warp per two rows, one warp slot of each 16 x 16 group: the
    // blur along W, the SSIM map and its partials, the partial maps' rows
    // and the warp sums, with no barrier but the warp's own
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
        const int o = 2 * warp + r, gy = y0 + o;
        float map_sum[2] = {0.0f, 0.0f}, l1_sum[2] = {0.0f, 0.0f};
        float dx[3][2][C], dy[PY ? 3 : 1][2][C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float b[5][2];
#pragma unroll
            for (int q = 0; q < 5; ++q) blur_w(hb + (q * C + c) * FWD_TH * SPAN, o, a.taps, b[q]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float mu1 = b[0][e], mu2 = b[1][e];
                const float s1 = b[2][e] - mu1 * mu1;
                const float s2 = b[3][e] - mu2 * mu2;
                const float s12 = b[4][e] - mu1 * mu2;
                const float map = ((2.0f * mu1 * mu2 + a.c1) * (2.0f * s12 + a.c2))
                                  / ((mu1 * mu1 + mu2 * mu2 + a.c1) * (s1 + s2 + a.c2));
                const bool in = gy < a.h && x0 + 2 * lane + e < a.w;
                const long long off = ((long long)gy * a.w + x0 + 2 * lane + e) * C + c;
                const float xv = in ? __ldg(a.x + off) : 0.0f;
                const float yv = in ? __ldg(a.y + off) : 0.0f;
                map_sum[e] += map;
                l1_sum[e] += fabsf(xv - yv);
                if (a.px) {
                    const Partials d = ssim_partials(mu1, mu2, s1, s2, s12, a.c1, a.c2);
                    dx[0][e][c] = d.d_mu;
                    dx[1][e][c] = d.d_p;
                    dx[2][e][c] = d.d_q;
                }
                if (PY) {
                    const Partials d = ssim_partials(mu2, mu1, s2, s1, s12, a.c1, a.c2);
                    dy[0][e][c] = d.d_mu;
                    dy[1][e][c] = d.d_p;
                    dy[2][e][c] = d.d_q;
                }
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const bool in = gy < a.h && x0 + 2 * lane + e < a.w;  // the twin pads with zeros
            psum[r * TW + 2 * lane + e] = in ? map_sum[e] : 0.0f;
            psum[(2 + r) * TW + 2 * lane + e] = in ? l1_sum[e] : 0.0f;
        }
        const long long f0 = ((long long)gy * a.w + x0) * C;
        if (a.px) {
            put_rows(orows, dx, a.px, hwc, f0);
            __syncwarp();
            if (gy < a.h)
                for (int m = 0; m < 3; ++m) write_row(a.px + m * hwc, f0, n_out, orows + m * OUT_ROW);
            __syncwarp();
        }
        if (PY) {
            put_rows(orows, dy, a.py, hwc, f0);
            __syncwarp();
            if (gy < a.h)
                for (int m = 0; m < 3; ++m) write_row(a.py + m * hwc, f0, n_out, orows + m * OUT_ROW);
            __syncwarp();
        }
    }
    __syncwarp();
    // the warp's slot of each group: a shuffle-down tree over its 2 x 16 pixels
    for (int t = 0; t < 2 * FWD_GX; ++t) {
        const int q = t / FWD_GX, gx = t % FWD_GX;
        float v = psum[(2 * q + (lane >> 4)) * TW + gx * GROUP + (lane & 15)];
        for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
        if (lane == 0) wsum[(q * FWD_GX + gx) * SLOTS + warp] = v;
    }
    __syncthreads();

    // each group's sum of its warp sums, in order, into its tile's slot
    const int tiles_x = (a.w + GROUP - 1) / GROUP, tiles_y = (a.h + GROUP - 1) / GROUP;
    const int tiles = tiles_x * tiles_y;
    if (threadIdx.x < 2 * FWD_GX) {
        const int q = threadIdx.x / FWD_GX, gx = threadIdx.x % FWD_GX;
        const int ty = blockIdx.y, tx = blockIdx.x * FWD_GX + gx;
        float s = 0.0f;
        for (int i = 0; i < SLOTS; ++i) s += wsum[(q * FWD_GX + gx) * SLOTS + i];
        if (ty < tiles_y && tx < tiles_x) a.block_sums[q * tiles + ty * tiles_x + tx] = s;
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned blocks = gridDim.x * gridDim.y;
        *last = atomicAdd(a.ticket, 1u) == blocks - 1;
        __threadfence();
    }
    __syncthreads();
    if (!*last) return;

    // the last block: the tile sums in double, lane i mod FINISH, then
    // the lanes halved pairwise (the H pass's planes are free)
    double* s_map = (double*)loss_smem;
    double* s_l1 = s_map + FINISH;
    for (int j = threadIdx.x; j < FINISH; j += THREADS) {
        double m = 0.0, l = 0.0;
#pragma unroll 8
        for (int i = j; i < tiles; i += FINISH) {
            m += (double)__ldcg(a.block_sums + i);
            l += (double)__ldcg(a.block_sums + tiles + i);
        }
        s_map[j] = m;
        s_l1[j] = l;
    }
    __syncthreads();
    for (int half = FINISH / 2; half > 0; half >>= 1) {
        for (int j = threadIdx.x; j < half; j += THREADS) {
            s_map[j] += s_map[j + half];
            s_l1[j] += s_l1[j + half];
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
        *a.ticket = 0u;
    }
}

__global__ void __launch_bounds__(THREADS, 2) loss_bwd_kernel(const LossBwdArgs a)
{
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* hb = loss_smem;                             // [3 C][BWD_TH][SPAN]: the blur along H
    float* orows = hb + BWD_HB + warp * 3 * OUT_ROW;  // this warp's [3][OUT_ROW]

    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * BWD_TH;
    const long long hwc = (long long)a.h * a.w * C;
    const int n_out = (a.w - x0 < TW ? a.w - x0 : TW) * C;
    const float gl = a.g_loss ? *a.g_loss : 0.0f;
    const float g1 = a.g_l1 ? *a.g_l1 : 0.0f;
    const float gs = a.g_ssim ? *a.g_ssim : 0.0f;
    const float ca = (a.olam * gl + g1) * a.inv_n;
    const float cb = (gs - a.lam * gl) * a.inv_n;
    const float* const maps[3] = {a.partials, a.partials + hwc, a.partials + 2 * hwc};

    // the blur along H of the whole tile, once
    blur_h<3, 3, BWD_TH>(hb, maps, a.h, a.w, x0, y0 - HALO, a.taps,
                         [](const float (&v)[3], float (&f)[3]) {
                             f[0] = v[0];
                             f[1] = v[1];
                             f[2] = v[2];
                         });
    __syncthreads();

    // then a warp per row: the blur along W and the gradient, with no
    // barrier but the warp's own
#pragma unroll 1
    for (int o = warp; o < BWD_TH; o += WARPS) {
        // the row of both images, in flight through the blur: 16-byte
        // chunks from the gradient's boundary
        const int gy = y0 + o;
        const long long f0 = ((long long)gy * a.w + x0) * C, end = f0 + n_out;
        const int sh = misalign(a.grad, f0);
        const long long a0 = f0 - sh;
        const bool vec_a = misalign(a.a, a0) == 0, vec_b = misalign(a.b, a0) == 0;
        float4 av[2], bv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int j = lane + 32 * i;
            if (gy < a.h && 4 * j < sh + n_out) {
                av[i] = load_chunk(a.a, a0 + 4 * j, f0, end, vec_a);
                bv[i] = load_chunk(a.b, a0 + 4 * j, f0, end, vec_b);
            }
        }
        float bl[3][2][C];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                float b[2];
                blur_w(hb + (q * C + c) * BWD_TH * SPAN, o, a.taps, b);
                bl[q][0][c] = b[0];
                bl[q][1][c] = b[1];
            }
        put_rows(orows, bl, a.grad, 0, f0);
        __syncwarp();
        if (gy < a.h) {
            // the gradient from the blurred fields and both images, 16 bytes at a time
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int j = lane + 32 * i;
                if (4 * j >= sh + n_out) break;
                const long long b = a0 + 4 * j;
                const bool whole = b >= f0 && b + 4 <= end;
                const float av4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
                const float bv4[4] = {bv[i].x, bv[i].y, bv[i].z, bv[i].w};
                const float4 m0 = load4(orows + 4 * j);
                const float4 m1 = load4(orows + OUT_ROW + 4 * j);
                const float4 m2 = load4(orows + 2 * OUT_ROW + 4 * j);
                const float d_mu[4] = {m0.x, m0.y, m0.z, m0.w};
                const float d_p[4] = {m1.x, m1.y, m1.z, m1.w};
                const float d_q[4] = {m2.x, m2.y, m2.z, m2.w};
                float g[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float d = av4[e] - bv4[e];
                    const float sign = (float)((0.0f < d) - (d < 0.0f));  // torch.sign
                    g[e] = ca * sign + cb * (d_mu[e] + 2.0f * av4[e] * d_p[e] + bv4[e] * d_q[e]);
                }
                if (whole) {
                    store4(a.grad + b, make_float4(g[0], g[1], g[2], g[3]));
                } else {
                    for (int e = 0; e < 4; ++e)
                        if (b + e >= f0 && b + e < end) a.grad[b + e] = g[e];
                }
            }
        }
        __syncwarp();  // before the warp's next row overwrites its rows
    }
}

// let a kernel take `bytes` (over 48 KB) of dynamic shared memory; the
// attribute lasts for the device's context, so it is set once per kernel and
// device (`done`, one flag per device) and not before every launch
constexpr int MAX_DEVICES = 64;
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<bool>* done)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && cached) done[dev].store(true, std::memory_order_release);
    return err;
}

std::atomic<bool> fwd_smem_set[2][MAX_DEVICES], bwd_smem_set[MAX_DEVICES];

}  // namespace

extern "C" int gs_loss_fwd(const LossFwdArgs* a, void* stream)
{
    if (a->h <= 0 || a->w <= 0 || !a->ticket) return (int)cudaErrorInvalidValue;
    const void* kernel = a->py ? (const void*)loss_fwd_kernel<true>
                               : (const void*)loss_fwd_kernel<false>;
    const cudaError_t err = allow_smem(kernel, FWD_SMEM, fwd_smem_set[a->py ? 1 : 0]);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a->w + TW - 1) / TW, (a->h + FWD_TH - 1) / FWD_TH);
    if (a->py)
        loss_fwd_kernel<true><<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(*a);
    else
        loss_fwd_kernel<false><<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int gs_loss_bwd(const LossBwdArgs* a, void* stream)
{
    if (a->h <= 0 || a->w <= 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem((const void*)loss_bwd_kernel, BWD_SMEM, bwd_smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a->w + TW - 1) / TW, (a->h + BWD_TH - 1) / BWD_TH);
    loss_bwd_kernel<<<grid, THREADS, BWD_SMEM, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

// The kernels as built and launched: per kernel (the forward as training
// launches it, without the ground truth's partials; the backward) its
// registers per thread, shared memory per block in bytes and blocks per SM.
extern "C" int gs_loss_info(int* out)
{
    const void* kernels[2] = {(const void*)loss_fwd_kernel<false>, (const void*)loss_bwd_kernel};
    const int smem[2] = {FWD_SMEM, BWD_SMEM};
    std::atomic<bool>* done[2] = {fwd_smem_set[0], bwd_smem_set};
    for (int i = 0; i < 2; ++i) {
        cudaError_t err = allow_smem(kernels[i], smem[i], done[i]);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernels[i]);
        if (err != cudaSuccess) return (int)err;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[i], THREADS, smem[i]);
        if (err != cudaSuccess) return (int)err;
        out[3 * i] = attr.numRegs;
        out[3 * i + 1] = smem[i] + (int)attr.sharedSizeBytes;
        out[3 * i + 2] = blocks;
    }
    return 0;
}
