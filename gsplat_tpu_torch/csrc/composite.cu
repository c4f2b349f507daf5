// The composite between the blend and the loss, forward (Cf') and backward
// (Cb'), sorted and OIT, on Hopper (sm_90a).
//
// Counterpart of the JAX package's background term, `tiles_to_image`,
// exposure affine and clip (gsplat_tpu/render.py:113-127) and of the OIT
// quotient (gsplat_tpu/ops/rasterize_pallas.py:1317), which XLA fuses into
// one pass under `jit`; none has a Pallas kernel. Eager PyTorch ran them as
// column views, three crops, the background multiply and add, the einsum
// and the clamp, and autograd their transposes, each a pass over the frame.
//
// The blend's raw output is (T, 256, 8) float32 in tile-major order: pixel
// (x, y) is row `((y / 16) * grid_x + x / 16) * 256 + (y % 16) * 16 + x % 16`,
//   sorted (K2'): [r, g, b, invdepth, final_T, n_contrib, 0, 0],
//   OIT (K5'):    [N0, N1, N2, N3, D, T, 0, 0], w = (1 - T) / max(D, 1e-8).
//
// `gs_composite_fwd`: a thread per output pixel, blocks of 32 x 8 pixels,
// so a warp is 32 pixels of one image row: it reads the pixel's 32-byte row
// as two float4 (two tiles' 512 contiguous bytes a warp) and writes the
// row-major render (H, W, 3), invdepth and final_t (H, W), each warp's
// stores contiguous. The colour is `c + T * bg`, then the optional exposure
// `o_d = ((img_0 E[0,d] + img_1 E[1,d]) + img_2 E[2,d]) + E[d,3]`, then the
// clamp to [0, 1] as torch's CUDA `clamp` writes it (NaN passes, else
// fminf(fmaxf(v, 0), 1)).
//
// `gs_composite_bwd`: a block per tile, a thread per padded pixel (slot), so
// the cotangent's 8 KB of a tile is written by one block as two float4 a
// pixel (K6' stages it so). A pixel outside the crop writes zeros. Inside,
// it recomputes the pre-clamp value from the raw output (nothing is saved
// by the forward), passes d render where that value lies in [0, 1] (torch's
// clamp backward, ends included, NaN stopped), through the exposure's
// transpose `dc_c = ((g_0 E[c,0] + g_1 E[c,1]) + g_2 E[c,2])`, and writes
//   sorted: [dc_0, dc_1, dc_2, d inv, ((dc_0 bg_0 + dc_1 bg_1) + dc_2 bg_2)
//            + d final_t, 0, 0, 0],
//   OIT:    [dc_c w, d inv w, dD, (bg term - dw / D') + d final_t, 0, 0],
//           dw = ((dc_0 N0 + dc_1 N1) + dc_2 N2) + d inv N3, D' = max(D, 1e-8),
//           dD = D >= 1e-8 ? -dw ((1 - T) / D' / D') : 0 (torch's division
//           and clamp_min derivatives),
// each value added to +0.0 as autograd's sum of zero-filled column
// gradients adds it. Where the exposure wants its gradient, each pixel's 12
// terms (img_c g_d, and g_c for the bias) go through a warp shuffle-down
// tree and the tile's eight warp sums in order into a per-tile partial; the
// last block to finish (an atomic ticket on a counter the wrapper keeps
// zeroed; that block zeroes it again) adds the partials in double, tile i
// into lane i mod 256, then the lanes halved pairwise.
//
// Float32 with -fmad=false and IEEE division, every operation in the plain
// twins' order (`composite_torch`, `composite_bwd_torch`,
// ops/composite.py), so both kernels equal them bit for bit on the card.
// Bound on the card: bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct CompositeFwdArgs {
    const float* raw;       // (T, 256, 8) the blend's output
    const float* bg;        // (3,)
    const float* exposure;  // (3, 4) or NULL
    float* render;          // (H, W, 3)
    float* invdepth;        // (H, W)
    float* final_t;         // (H, W)
    int grid_x, grid_y, width, height, oit;
};

struct CompositeBwdArgs {
    const float* raw;         // (T, 256, 8) the blend's output
    const float* bg;          // (3,)
    const float* exposure;    // (3, 4) or NULL
    const float* d_render;    // (H, W, 3) or NULL (zeros)
    const float* d_invdepth;  // (H, W) or NULL
    const float* d_final_t;   // (H, W) or NULL
    float* cot;               // (T, 256, 8) out
    float* partials;          // (T, 12) per-tile exposure sums, or NULL
    float* d_exposure;        // (3, 4) out, or NULL: no exposure gradient
    unsigned int* ticket;     // () zero before the launch, zero after it
    int grid_x, grid_y, width, height, oit;
};

namespace {

constexpr int TILE = 16;
constexpr int PPT = TILE * TILE;
constexpr int FWD_W = 32, FWD_H = 8;        // a forward block's pixels
constexpr int WARPS = PPT / 32;             // a backward block's warps
constexpr int TERMS = 12;                   // the exposure gradient's sums
constexpr int FINISH = 256;                 // lanes of their double sum
constexpr int FIN_OFFSET = 128;             // floats before the double lanes
constexpr int BWD_SMEM = (FIN_OFFSET + 2 * TERMS * FINISH) * 4;
constexpr float MIN_DENOM = 1e-8f;
static_assert(WARPS * TERMS + 1 <= FIN_OFFSET, "the warp sums and the flag fit");
static_assert(FINISH == PPT, "a thread a lane of the finish");

// torch's CUDA clamp and clamp_min: NaN passes, else fminf/fmaxf
__device__ __forceinline__ float clamp01(float v)
{
    return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float clamp_min(float v, float lo)
{
    return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ size_t raw_row(int grid_x, int x, int y)
{
    return ((size_t)((y / TILE) * grid_x + x / TILE) * PPT + (y % TILE) * TILE + x % TILE) * 8;
}

struct Pixel {
    float img[3];  // colour after the background term
    float inv, t, w;
};

template <bool OIT>
__device__ __forceinline__ Pixel colour(const float4 lo, const float4 hi, const float* bg)
{
    Pixel p;
    float c[3];
    if (OIT) {
        p.t = hi.y;
        p.w = (1.0f - p.t) / clamp_min(hi.x, MIN_DENOM);
        c[0] = lo.x * p.w;
        c[1] = lo.y * p.w;
        c[2] = lo.z * p.w;
        p.inv = lo.w * p.w;
    } else {
        p.t = hi.x;
        p.w = 1.0f;
        c[0] = lo.x;
        c[1] = lo.y;
        c[2] = lo.z;
        p.inv = lo.w;
    }
    for (int i = 0; i < 3; ++i) p.img[i] = c[i] + p.t * bg[i];
    return p;
}

template <bool EXPOSURE>
__device__ __forceinline__ void expose(const float* img, const float* e, float* o)
{
    for (int d = 0; d < 3; ++d)
        o[d] = EXPOSURE ? ((img[0] * e[d] + img[1] * e[4 + d]) + img[2] * e[8 + d]) + e[4 * d + 3]
                        : img[d];
}

template <bool OIT, bool EXPOSURE>
__global__ void __launch_bounds__(FWD_W * FWD_H) composite_fwd_kernel(const CompositeFwdArgs a)
{
    const int x = blockIdx.x * FWD_W + threadIdx.x;
    const int y = blockIdx.y * FWD_H + threadIdx.y;
    if (x >= a.width || y >= a.height) return;
    const float* row = a.raw + raw_row(a.grid_x, x, y);
    const float4 lo = *reinterpret_cast<const float4*>(row);
    const float4 hi = *reinterpret_cast<const float4*>(row + 4);
    const Pixel p = colour<OIT>(lo, hi, a.bg);
    float o[3];
    expose<EXPOSURE>(p.img, a.exposure, o);
    const size_t pix = (size_t)y * a.width + x;
    for (int d = 0; d < 3; ++d) a.render[3 * pix + d] = clamp01(o[d]);
    a.invdepth[pix] = p.inv;
    a.final_t[pix] = p.t;
}

template <bool OIT, bool EXPOSURE>
__global__ void __launch_bounds__(PPT) composite_bwd_kernel(const CompositeBwdArgs a)
{
    extern __shared__ __align__(16) float comp_smem[];
    const int tile = blockIdx.x, slot = threadIdx.x;
    const int x = (tile % a.grid_x) * TILE + slot % TILE;
    const int y = (tile / a.grid_x) * TILE + slot / TILE;
    float cot[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float terms[TERMS];
    for (int k = 0; k < TERMS; ++k) terms[k] = 0.0f;
    float* out = a.cot + ((size_t)tile * PPT + slot) * 8;
    if (x < a.width && y < a.height) {
        const float* row = a.raw + ((size_t)tile * PPT + slot) * 8;
        const float4 lo = *reinterpret_cast<const float4*>(row);
        const float4 hi = *reinterpret_cast<const float4*>(row + 4);
        const Pixel p = colour<OIT>(lo, hi, a.bg);
        const size_t pix = (size_t)y * a.width + x;
        float g[3] = {0.0f, 0.0f, 0.0f};
        if (a.d_render) {
            float o[3];
            expose<EXPOSURE>(p.img, a.exposure, o);
            for (int d = 0; d < 3; ++d)
                g[d] = (o[d] >= 0.0f && o[d] <= 1.0f) ? a.d_render[3 * pix + d] : 0.0f;
        }
        float dc[3];
        const float* e = a.exposure;
        for (int c = 0; c < 3; ++c)
            dc[c] = EXPOSURE ? (g[0] * e[4 * c] + g[1] * e[4 * c + 1]) + g[2] * e[4 * c + 2]
                             : g[c];
        if (EXPOSURE)
            for (int c = 0; c < 3; ++c) {
                for (int d = 0; d < 3; ++d) terms[4 * c + d] = p.img[c] * g[d];
                terms[4 * c + 3] = g[c];
            }
        const float dinv = a.d_invdepth ? a.d_invdepth[pix] : 0.0f;
        const float dft = a.d_final_t ? a.d_final_t[pix] : 0.0f;
        const float bg_term = (dc[0] * a.bg[0] + dc[1] * a.bg[1]) + dc[2] * a.bg[2];
        if (OIT) {
            const float denom = clamp_min(hi.x, MIN_DENOM);
            const float one_m = 1.0f - p.t;
            const float dw = ((dc[0] * lo.x + dc[1] * lo.y) + dc[2] * lo.z) + dinv * lo.w;
            const float d_denom = -dw * ((one_m / denom) / denom);
            for (int c = 0; c < 3; ++c) cot[c] = dc[c] * p.w;
            cot[3] = dinv * p.w;
            cot[4] = hi.x >= MIN_DENOM ? d_denom : 0.0f;
            cot[5] = (bg_term - dw / denom) + dft;
        } else {
            for (int c = 0; c < 3; ++c) cot[c] = dc[c];
            cot[3] = dinv;
            cot[4] = bg_term + dft;
        }
        for (int i = 0; i < 8; ++i) cot[i] = cot[i] + 0.0f;  // -0 to +0, as autograd's sum
    }
    reinterpret_cast<float4*>(out)[0] = make_float4(cot[0], cot[1], cot[2], cot[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(cot[4], cot[5], cot[6], cot[7]);
    if (!EXPOSURE || !a.d_exposure) return;  // uniform over the grid

    // the exposure's gradient: a warp's shuffle-down tree, the tile's warp
    // sums in order, then the last block's double sum of the tiles
    float* wsum = comp_smem;  // [WARPS][TERMS]
    int* last = reinterpret_cast<int*>(comp_smem + WARPS * TERMS);
    const int lane = slot % 32, warp = slot / 32;
    for (int k = 0; k < TERMS; ++k) {
        float v = terms[k];
        for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
        if (lane == 0) wsum[warp * TERMS + k] = v;
    }
    __syncthreads();
    if (slot < TERMS) {
        float s = 0.0f;
        for (int w = 0; w < WARPS; ++w) s += wsum[w * TERMS + slot];
        a.partials[(size_t)tile * TERMS + slot] = s;
        __threadfence();
    }
    __syncthreads();
    if (slot == 0) {
        *last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
        __threadfence();
    }
    __syncthreads();
    if (!*last) return;

    double* fin = reinterpret_cast<double*>(comp_smem + FIN_OFFSET);  // [TERMS][FINISH]
    const int tiles = gridDim.x;
    for (int k = 0; k < TERMS; ++k) {
        double acc = 0.0;
        for (int i = slot; i < tiles; i += FINISH)
            acc += (double)__ldcg(a.partials + (size_t)i * TERMS + k);
        fin[k * FINISH + slot] = acc;
    }
    __syncthreads();
    for (int half = FINISH / 2; half > 0; half >>= 1) {
        if (slot < half)
            for (int k = 0; k < TERMS; ++k) fin[k * FINISH + slot] += fin[k * FINISH + slot + half];
        __syncthreads();
    }
    if (slot < TERMS) a.d_exposure[slot] = (float)fin[slot * FINISH];
    if (slot == 0) *a.ticket = 0u;
}

typedef void (*FwdKernel)(const CompositeFwdArgs);
typedef void (*BwdKernel)(const CompositeBwdArgs);

FwdKernel fwd_kernel(bool oit, bool exposure)
{
    if (oit) return exposure ? composite_fwd_kernel<true, true> : composite_fwd_kernel<true, false>;
    return exposure ? composite_fwd_kernel<false, true> : composite_fwd_kernel<false, false>;
}

BwdKernel bwd_kernel(bool oit, bool exposure)
{
    if (oit) return exposure ? composite_bwd_kernel<true, true> : composite_bwd_kernel<true, false>;
    return exposure ? composite_bwd_kernel<false, true> : composite_bwd_kernel<false, false>;
}

bool bad_frame(int grid_x, int grid_y, int width, int height)
{
    return width <= 0 || height <= 0 || grid_x != (width + TILE - 1) / TILE
           || grid_y != (height + TILE - 1) / TILE;
}

}  // namespace

extern "C" int gs_composite_fwd(const CompositeFwdArgs* a, void* stream)
{
    if (bad_frame(a->grid_x, a->grid_y, a->width, a->height) || !a->raw || !a->bg)
        return (int)cudaErrorInvalidValue;
    const FwdKernel k = fwd_kernel(a->oit != 0, a->exposure != nullptr);
    const dim3 grid((a->width + FWD_W - 1) / FWD_W, (a->height + FWD_H - 1) / FWD_H);
    const dim3 block(FWD_W, FWD_H);
    k<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int gs_composite_bwd(const CompositeBwdArgs* a, void* stream)
{
    if (bad_frame(a->grid_x, a->grid_y, a->width, a->height) || !a->raw || !a->bg
        || (a->d_exposure && (!a->exposure || !a->partials || !a->ticket)))
        return (int)cudaErrorInvalidValue;
    const BwdKernel k = bwd_kernel(a->oit != 0, a->exposure != nullptr);
    const dim3 grid(a->grid_x * a->grid_y);
    const int smem = a->d_exposure ? BWD_SMEM : 0;
    k<<<grid, PPT, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
