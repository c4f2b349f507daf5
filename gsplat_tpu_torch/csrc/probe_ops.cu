// Probes P3' and P4': the cost of the blend's building blocks on one SM, on
// Hopper (sm_90a).
//
// P3' replaces the Pallas op-rate kernels of scripts/probe_mm.py (`k_cumprod`,
// `k_vpu9`, `k_exp`, `k_div`, `k_cvpu`, `k_cmatmul`, `k_two_matmuls`,
// `k_merged`, `k_fwd_accum`, `make_kappa`; :54-165, launched by `bench`,
// :27-31). P4' replaces `make_kernel` of scripts/probe_r5_bf16vpu.py (:35,
// launched by `run`, :62-64), the forward blend's op mix in float32 and in
// bf16 arithmetic.
//
// Each kernel computes its JAX kernel's function: the same iterations (1000
// for P3, 2000 for P4, passed as `n_it`), the same shapes and the same
// operation order. A P3 iteration reads the previous one through `dep`
// (probe_mm.py:49-51): every input element gets row 0 of the last result
// times 1e-20 (`k_fwd_accum`: column 0, per row; `k_cvpu` and `k_cmatmul`:
// the sum of row 0). The contractions (`k_cmatmul` to `make_kappa`) are
// float32 sums written here on the CUDA cores with fmaf; the elementwise
// variants and `k_cvpu` keep the separate multiplies and adds of their JAX
// bodies (-fmad=false).
//
// One block holds the whole working set: it is the per-SM counterpart of the
// TPU core's VMEM block, so the probes' bound is one SM's peak. Row 0 of a
// result feeds the next iteration through shared memory, so every iteration
// ends at a block-wide barrier (double-buffered: one barrier an iteration;
// `k_two_matmuls` and `k_merged` add one for their cross-warp sum, and
// `k_fwd_accum`, whose feedback stays inside a row, keeps its barrier so that
// its reads of `feat` stay in the loop as the TPU kernel's VMEM reads do).
//
// Dead code is the trap (probe_mm.py:4-8): only row 0 of a result is read
// again, so a compiler may compute the other rows only in the last
// iteration, or only under the branch that stores the fed-back row. So the
// row (or column) that feeds back is a kernel argument, 0 at run time, and
// every output row is stored in every iteration, unconditionally: the
// fed-back row to the next iteration's buffer, the others to one trash slot
// in shared memory that nothing reads. Choosing the slot and the store are
// part of every measured iteration (about two instructions per 4 to 32
// outputs). The last iteration is peeled and writes the result.
//
// P4' (blend_mix_*): per element, 2000 iterations of
//   x2 = acc * 0.5 + 1; p = -(x2 * x2) * 0.5; g = exp(p); a = min(x2 * g, 1);
//   keep = p <= 0 and a >= 1e-4 (compared in float32); a = keep ? a : 0;
//   acc = acc + a * 0.5
// from acc = x. The elements are independent, so a thread walks 8 of them
// together (for ILP) and no barrier is needed. The float32 kernel is plain
// float. The bf16 kernel keeps bf16 values two to a register
// (`__nv_bfloat162`): each mul and add rounds to bf16 on its own
// (`__hmul2_rn`, `__hadd2_rn`, never fused), the exp and the min are packed
// (`h2exp`, `__hmin2`), and the keep compares run in float32 after a
// conversion, as the JAX probe's note says (:46-53).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int ROWS = 256;
constexpr int LANES = 128;
constexpr float DEP_SCALE = 1e-20f;
constexpr unsigned FULL = 0xffffffffu;
using Last = std::true_type;
using NotLast = std::false_type;

// ---------------------------------------------------------------- layouts
// 512 threads, warp w owns rows [16 w, 16 w + 16), lane l columns
// [4 l, 4 l + 4) of each 128-wide column block.
constexpr int BLOCK = 512;
constexpr int ROWS_PER_WARP = ROWS / (BLOCK / 32);
// the contractions over 256 rows: thread (l, q) sums rows [64 q, 64 q + 64)
// of column l; the four partial sums meet in shared memory
constexpr int SLICES = BLOCK / LANES;
constexpr int DEPTH = ROWS / SLICES;

// a read of the trash slot under a condition that never holds (the fed-back
// row is never negative), so that no compiler can prove its stores dead
__device__ __forceinline__ void keep_trash(const float4& trash, float* out, int dep_row)
{
    if (dep_row < 0) out[0] = trash.x;
}

__device__ __forceinline__ float4 f4(const float (&e)[4])
{
    return make_float4(e[0], e[1], e[2], e[3]);
}

// ------------------------------------------------------- elementwise (P3)
enum { OP_CUMPROD = 0, OP_VPU9 = 1, OP_EXP = 2, OP_DIV = 3 };

// inclusive lane cumprod of a 128-wide row held 4 to a thread, by the
// Hillis-Steele doubling of `k_cumprod`: at step s element i takes
// v[i] * (i >= s ? v[i - s] : 1)
__device__ __forceinline__ void cumprod_row(float (&e)[4], int lane)
{
    {   // s = 1
        const float n3 = __shfl_up_sync(FULL, e[3], 1);
        e[3] = e[3] * e[2];
        e[2] = e[2] * e[1];
        e[1] = e[1] * e[0];
        e[0] = e[0] * (lane >= 1 ? n3 : 1.0f);
    }
    {   // s = 2
        const float n2 = __shfl_up_sync(FULL, e[2], 1);
        const float n3 = __shfl_up_sync(FULL, e[3], 1);
        e[3] = e[3] * e[1];
        e[2] = e[2] * e[0];
        e[1] = e[1] * (lane >= 1 ? n3 : 1.0f);
        e[0] = e[0] * (lane >= 1 ? n2 : 1.0f);
    }
#pragma unroll
    for (int t = 1; t <= 16; t *= 2) {  // s = 4 t: t threads up
        float sh[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) sh[m] = __shfl_up_sync(FULL, e[m], t);
#pragma unroll
        for (int m = 0; m < 4; ++m) e[m] = e[m] * (lane >= t ? sh[m] : 1.0f);
    }
}

template <int OP>
__device__ __forceinline__ void elementwise(float (&e)[4], const float (&x)[4], int lane)
{
    if constexpr (OP == OP_CUMPROD) {
        cumprod_row(e, lane);
    } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float v = e[m];
            if constexpr (OP == OP_VPU9) {
#pragma unroll
                for (int j = 0; j < 3; ++j) v = v * x[m] + x[m];
                v = v * 1.0000001f;
            } else if constexpr (OP == OP_EXP) {
                v = expf(v * 1e-3f);
            } else {
                v = 1.0f / (1.5f + v * 1e-3f);
            }
            e[m] = v;
        }
    }
}

// `k_cumprod`, `k_vpu9`, `k_exp`, `k_div`: x (256, 128) -> (256, 128), each
// element of a result f(x + acc[0, col] * 1e-20); x lives in registers
template <int OP>
__global__ void __launch_bounds__(BLOCK) elementwise_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n_it, int dep_row)
{
    __shared__ float4 dep[2][LANES / 4];
    __shared__ float4 trash;
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * ROWS_PER_WARP;
    float4 xr[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
        xr[i] = reinterpret_cast<const float4*>(x)[(r0 + i) * (LANES / 4) + lane];
    if (threadIdx.x < 2 * LANES / 4) dep[threadIdx.x / 32][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    auto step = [&](int it, auto last) {
        const float4 a = dep[it & 1][lane];
        const float sa[4] = {a.x * DEP_SCALE, a.y * DEP_SCALE, a.z * DEP_SCALE, a.w * DEP_SCALE};
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const float xe[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
            float e[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) e[m] = xe[m] + sa[m];
            elementwise<OP>(e, xe, lane);
            *(r0 + i == dep_row ? &dep[(it + 1) & 1][lane] : &trash) = f4(e);
            if constexpr (decltype(last)::value)
                reinterpret_cast<float4*>(out)[(r0 + i) * (LANES / 4) + lane] = f4(e);
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    keep_trash(trash, out, dep_row);
}

// ------------------------------------------------ K = 4 contraction (P3)
// `k_cvpu` (FUSED = false: ((d0 f0 + d1 f1) + d2 f2) + d3 f3 as separate
// multiplies and adds) and `k_cmatmul` (FUSED = true: the same sum as fmaf):
// dpix (256, 4), feat (4, 128) -> (256, 128), with f = feat + sum(acc[0]) * 1e-20
template <bool FUSED>
__global__ void __launch_bounds__(BLOCK) contract4_kernel(
    const float* __restrict__ dpix, const float* __restrict__ feat, float* __restrict__ out,
    int n_it, int dep_row)
{
    __shared__ float4 d_s[ROWS];
    __shared__ float4 dep[2][LANES / 4];
    __shared__ float4 trash;
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * ROWS_PER_WARP;
    float4 fr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) fr[k] = reinterpret_cast<const float4*>(feat)[k * (LANES / 4) + lane];
    for (int r = threadIdx.x; r < ROWS; r += BLOCK) d_s[r] = reinterpret_cast<const float4*>(dpix)[r];
    if (threadIdx.x < 2 * LANES / 4) dep[threadIdx.x / 32][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    auto step = [&](int it, auto last) {
        // every warp sums the fed-back row in the same order
        const float4 a = dep[it & 1][lane];
        float sum = ((a.x + a.y) + a.z) + a.w;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        const float ss = sum * DEP_SCALE;
        float f[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            f[k][0] = fr[k].x + ss;
            f[k][1] = fr[k].y + ss;
            f[k][2] = fr[k].z + ss;
            f[k][3] = fr[k].w + ss;
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const float4 d = d_s[r0 + i];
            float c[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                if constexpr (FUSED)
                    c[m] = fmaf(d.w, f[3][m], fmaf(d.z, f[2][m], fmaf(d.y, f[1][m], d.x * f[0][m])));
                else
                    c[m] = ((d.x * f[0][m] + d.y * f[1][m]) + d.z * f[2][m]) + d.w * f[3][m];
            }
            *(r0 + i == dep_row ? &dep[(it + 1) & 1][lane] : &trash) = f4(c);
            if constexpr (decltype(last)::value)
                reinterpret_cast<float4*>(out)[(r0 + i) * (LANES / 4) + lane] = f4(c);
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    keep_trash(trash, out, dep_row);
}

// ---------------------------------------------- 256-deep contractions (P3)
// shared memory of `k_two_matmuls`: y (256, 128); basis (256, 6) padded to 8;
// dpix (256, 4); the partial sums (4, 10, 128); the feedback row (2, 128);
// the trash slot
constexpr int TWO_SMEM = (ROWS * LANES + ROWS * 8 + ROWS * 4 + SLICES * 10 * LANES + 2 * LANES + 1) * 4;

// `k_two_matmuls`: mom = basis^T (x + acc[0] * 1e-20) (6, 128) and dfeat =
// dpix^T y (4, 128) -> (16, 128) [mom; dfeat; 0]. x stays in registers (64
// values a thread); y, basis and dpix are read from shared memory in every
// iteration
__global__ void __launch_bounds__(BLOCK) two_matmuls_kernel(
    const float* __restrict__ basis, const float* __restrict__ dpix, const float* __restrict__ x,
    const float* __restrict__ y, float* __restrict__ out, int n_it, int dep_row)
{
    extern __shared__ float4 smem4[];
    float* y_s = reinterpret_cast<float*>(smem4);
    float4* basis_s = reinterpret_cast<float4*>(y_s + ROWS * LANES);  // 2 per row
    float4* dpix_s = basis_s + 2 * ROWS;
    float* part = reinterpret_cast<float*>(dpix_s + ROWS);
    float* dep = part + SLICES * 10 * LANES;
    float* trash = dep + 2 * LANES;

    const int l = threadIdx.x % LANES;
    const int q = threadIdx.x / LANES;
    float xr[DEPTH];
#pragma unroll
    for (int kk = 0; kk < DEPTH; ++kk) xr[kk] = x[(q * DEPTH + kk) * LANES + l];
    for (int i = threadIdx.x; i < ROWS * LANES; i += BLOCK) y_s[i] = y[i];
    for (int r = threadIdx.x; r < ROWS; r += BLOCK) {
        const float* b = basis + r * 6;
        basis_s[2 * r] = make_float4(b[0], b[1], b[2], b[3]);
        basis_s[2 * r + 1] = make_float4(b[4], b[5], 0.f, 0.f);
        dpix_s[r] = reinterpret_cast<const float4*>(dpix)[r];
    }
    for (int i = threadIdx.x; i < 2 * LANES; i += BLOCK) dep[i] = 0.f;
    __syncthreads();

    auto step = [&](int it, auto last) {
        const float sa = dep[(it & 1) * LANES + l] * DEP_SCALE;
        float acc[10];
#pragma unroll
        for (int r = 0; r < 10; ++r) acc[r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DEPTH; ++kk) {
            const int k = q * DEPTH + kk;
            const float xk = xr[kk] + sa;
            const float4 b0 = basis_s[2 * k], b1 = basis_s[2 * k + 1];
            acc[0] = fmaf(b0.x, xk, acc[0]);
            acc[1] = fmaf(b0.y, xk, acc[1]);
            acc[2] = fmaf(b0.z, xk, acc[2]);
            acc[3] = fmaf(b0.w, xk, acc[3]);
            acc[4] = fmaf(b1.x, xk, acc[4]);
            acc[5] = fmaf(b1.y, xk, acc[5]);
            const float yk = y_s[k * LANES + l];
            const float4 d = dpix_s[k];
            acc[6] = fmaf(d.x, yk, acc[6]);
            acc[7] = fmaf(d.y, yk, acc[7]);
            acc[8] = fmaf(d.z, yk, acc[8]);
            acc[9] = fmaf(d.w, yk, acc[9]);
        }
#pragma unroll
        for (int r = 0; r < 10; ++r) part[(q * 10 + r) * LANES + l] = acc[r];
        __syncthreads();
        for (int r = q; r < 10; r += SLICES) {
            float v = part[r * LANES + l];
#pragma unroll
            for (int s = 1; s < SLICES; ++s) v = v + part[(s * 10 + r) * LANES + l];
            *(r == dep_row ? &dep[((it + 1) & 1) * LANES + l] : trash) = v;
            if constexpr (decltype(last)::value) out[r * LANES + l] = v;
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    for (int i = threadIdx.x; i < 6 * LANES; i += BLOCK) out[10 * LANES + i] = 0.f;
}

// shared memory of `k_merged`: y (256, 128); bd (256, 10) padded to 12; the
// partial sums (4, 20, 128); the feedback row (2, 128); the trash slot
constexpr int MERGED_SMEM = (ROWS * LANES + ROWS * 12 + SLICES * 20 * LANES + 2 * LANES + 1) * 4;

// `k_merged`: bd^T [x + acc[0, 0:128] * 1e-20 | y] (10, 256) -> (16, 256)
// [both; 0]. `dep_col0` is where the fed-back 128 columns start (0)
__global__ void __launch_bounds__(BLOCK) merged_kernel(
    const float* __restrict__ bd, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int n_it, int dep_row, int dep_col0)
{
    extern __shared__ float4 smem4[];
    float* y_s = reinterpret_cast<float*>(smem4);
    float4* bd_s = reinterpret_cast<float4*>(y_s + ROWS * LANES);  // 3 per row
    float* part = reinterpret_cast<float*>(bd_s + 3 * ROWS);
    float* dep = part + SLICES * 20 * LANES;
    float* trash = dep + 2 * LANES;

    const int l = threadIdx.x % LANES;
    const int q = threadIdx.x / LANES;
    float xr[DEPTH];
#pragma unroll
    for (int kk = 0; kk < DEPTH; ++kk) xr[kk] = x[(q * DEPTH + kk) * LANES + l];
    for (int i = threadIdx.x; i < ROWS * LANES; i += BLOCK) y_s[i] = y[i];
    for (int r = threadIdx.x; r < ROWS; r += BLOCK) {
        const float* b = bd + r * 10;
        bd_s[3 * r] = make_float4(b[0], b[1], b[2], b[3]);
        bd_s[3 * r + 1] = make_float4(b[4], b[5], b[6], b[7]);
        bd_s[3 * r + 2] = make_float4(b[8], b[9], 0.f, 0.f);
    }
    for (int i = threadIdx.x; i < 2 * LANES; i += BLOCK) dep[i] = 0.f;
    __syncthreads();

    auto step = [&](int it, auto last) {
        const float sa = dep[(it & 1) * LANES + l] * DEP_SCALE;
        float ax[10], ay[10];
#pragma unroll
        for (int r = 0; r < 10; ++r) ax[r] = ay[r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DEPTH; ++kk) {
            const int k = q * DEPTH + kk;
            const float xk = xr[kk] + sa;
            const float yk = y_s[k * LANES + l];
            const float4 b0 = bd_s[3 * k], b1 = bd_s[3 * k + 1], b2 = bd_s[3 * k + 2];
            const float b[10] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y};
#pragma unroll
            for (int r = 0; r < 10; ++r) {
                ax[r] = fmaf(b[r], xk, ax[r]);
                ay[r] = fmaf(b[r], yk, ay[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < 10; ++r) {
            part[(q * 20 + r) * LANES + l] = ax[r];
            part[(q * 20 + 10 + r) * LANES + l] = ay[r];
        }
        __syncthreads();
        for (int idx = q; idx < 20; idx += SLICES) {  // (row, column half)
            const int r = idx % 10;
            const int col0 = idx < 10 ? 0 : LANES;
            float v = part[idx * LANES + l];
#pragma unroll
            for (int s = 1; s < SLICES; ++s) v = v + part[(s * 20 + idx) * LANES + l];
            *(r == dep_row && col0 == dep_col0 ? &dep[((it + 1) & 1) * LANES + l] : trash) = v;
            if constexpr (decltype(last)::value) out[r * 2 * LANES + col0 + l] = v;
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    for (int i = threadIdx.x; i < 6 * 2 * LANES; i += BLOCK) out[10 * 2 * LANES + i] = 0.f;
}

// `k_fwd_accum`: (w + acc[:, 0] * 1e-20) feat^T (256, 4) -> (256, 128)
// [a, 0]. Thread (r, q) of 1024 sums row r over columns k = 4 kk + q of w
// (32 values in registers); the four meet by shuffles, so the row that feeds
// back stays in the warp. `dep_col` is the fed-back column (0)
constexpr int FA_BLOCK = 1024;

__global__ void __launch_bounds__(FA_BLOCK) fwd_accum_kernel(
    const float* __restrict__ w, const float* __restrict__ feat, float* __restrict__ out,
    int n_it, int dep_col)
{
    __shared__ float4 feat_s[LANES];  // feat_s[k] = feat[0:4, k]
    const int r = threadIdx.x / 4;
    const int q = threadIdx.x % 4;
    float wr[LANES / 4];
#pragma unroll
    for (int kk = 0; kk < LANES / 4; ++kk) wr[kk] = w[r * LANES + 4 * kk + q];
    for (int k = threadIdx.x; k < LANES; k += FA_BLOCK)
        feat_s[k] = make_float4(feat[k], feat[LANES + k], feat[2 * LANES + k], feat[3 * LANES + k]);
    __syncthreads();

    float o[4] = {0.f, 0.f, 0.f, 0.f};  // row r of the last result, columns 0-3
    auto step = [&](auto last) {
        const float a = dep_col == 0 ? o[0] : dep_col == 1 ? o[1] : dep_col == 2 ? o[2]
                      : dep_col == 3 ? o[3] : 0.f;
        const float sa = a * DEP_SCALE;
        float n[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < LANES / 4; ++kk) {
            const float wk = wr[kk] + sa;
            const float4 f = feat_s[4 * kk + q];
            n[0] = fmaf(wk, f.x, n[0]);
            n[1] = fmaf(wk, f.y, n[1]);
            n[2] = fmaf(wk, f.z, n[2]);
            n[3] = fmaf(wk, f.w, n[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            n[c] += __shfl_xor_sync(FULL, n[c], 1);
            n[c] += __shfl_xor_sync(FULL, n[c], 2);
            o[c] = n[c];
        }
        if constexpr (decltype(last)::value)
            if (q == 0) reinterpret_cast<float4*>(out)[r * (LANES / 4)] = f4(o);
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(NotLast{});
    step(Last{});
    for (int i = threadIdx.x; i < ROWS * LANES; i += FA_BLOCK)
        if (i % LANES >= 4) out[i] = 0.f;
}

// `make_kappa(KAPPA)`: basis (256, 8) (q + acc[0] * 1e-20) -> (256, 128 KAPPA),
// each output a sum of 8 products. Warp w takes column block w % KAPPA (4
// columns a lane) and 16 KAPPA rows; the 32 values of its block of q stay in
// registers, basis rows come from shared memory
template <int KAPPA>
__global__ void __launch_bounds__(BLOCK) kappa_kernel(
    const float* __restrict__ basis, const float* __restrict__ q, float* __restrict__ out,
    int n_it, int dep_row)
{
    constexpr int C4 = LANES * KAPPA / 4;  // float4 columns
    constexpr int WARP_ROWS = ROWS_PER_WARP * KAPPA;
    __shared__ float4 basis_s[ROWS][2];
    __shared__ float4 q_s[8][C4];
    __shared__ float4 dep[2][C4];
    __shared__ float4 trash;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c4 = (warp % KAPPA) * 32 + lane;
    const int r0 = (warp / KAPPA) * WARP_ROWS;
    for (int r = threadIdx.x; r < ROWS; r += BLOCK) {
        basis_s[r][0] = reinterpret_cast<const float4*>(basis)[2 * r];
        basis_s[r][1] = reinterpret_cast<const float4*>(basis)[2 * r + 1];
    }
    for (int i = threadIdx.x; i < 8 * C4; i += BLOCK)
        q_s[i / C4][i % C4] = reinterpret_cast<const float4*>(q)[i];
    for (int i = threadIdx.x; i < 2 * C4; i += BLOCK)
        dep[i / C4][i % C4] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    auto step = [&](int it, auto last) {
        const float4 a = dep[it & 1][c4];
        const float sa[4] = {a.x * DEP_SCALE, a.y * DEP_SCALE, a.z * DEP_SCALE, a.w * DEP_SCALE};
        float qp[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float4 v = q_s[k][c4];
            qp[k][0] = v.x + sa[0];
            qp[k][1] = v.y + sa[1];
            qp[k][2] = v.z + sa[2];
            qp[k][3] = v.w + sa[3];
        }
#pragma unroll
        for (int i = 0; i < WARP_ROWS; ++i) {
            const int r = r0 + i;
            const float4 b0 = basis_s[r][0], b1 = basis_s[r][1];
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            float p[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                p[m] = b[0] * qp[0][m];
#pragma unroll
                for (int k = 1; k < 8; ++k) p[m] = fmaf(b[k], qp[k][m], p[m]);
            }
            *(r == dep_row ? &dep[(it + 1) & 1][c4] : &trash) = f4(p);
            if constexpr (decltype(last)::value)
                reinterpret_cast<float4*>(out)[r * C4 + c4] = f4(p);
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    keep_trash(trash, out, dep_row);
}

// ------------------------------------------------------------- P4 op mix
constexpr int MIX_BLOCK = 1024;
constexpr int MIX_ILP = 8;  // independent elements (pairs for bf16) a thread walks together

__global__ void __launch_bounds__(MIX_BLOCK) blend_mix_f32_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int n_it)
{
    for (int b = threadIdx.x * MIX_ILP; b < n; b += MIX_BLOCK * MIX_ILP) {
        float acc[MIX_ILP];
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) acc[e] = x[b + e];
        for (int it = 0; it < n_it; ++it) {
#pragma unroll
            for (int e = 0; e < MIX_ILP; ++e) {
                const float x2 = acc[e] * 0.5f + 1.0f;
                const float p = -(x2 * x2) * 0.5f;
                const float g = expf(p);
                float a = fminf(x2 * g, 1.0f);
                const bool keep = (p <= 0.0f) & (a >= 1e-4f);
                a = keep ? a : 0.0f;
                acc[e] = acc[e] + a * 0.5f;
            }
        }
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) out[b + e] = acc[e];
    }
}

__global__ void __launch_bounds__(MIX_BLOCK) blend_mix_bf16_kernel(
    const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out, int n2, int n_it)
{
    const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
    const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int b = threadIdx.x * MIX_ILP; b < n2; b += MIX_BLOCK * MIX_ILP) {
        __nv_bfloat162 acc[MIX_ILP];
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) acc[e] = x[b + e];
        for (int it = 0; it < n_it; ++it) {
#pragma unroll
            for (int e = 0; e < MIX_ILP; ++e) {
                const __nv_bfloat162 x2 = __hadd2_rn(__hmul2_rn(acc[e], half), one);
                const __nv_bfloat162 p = __hmul2_rn(__hneg2(__hmul2_rn(x2, x2)), half);
                const __nv_bfloat162 g = h2exp(p);
                __nv_bfloat162 a = __hmin2(__hmul2_rn(x2, g), one);
                const float2 pf = __bfloat1622float2(p);
                const float2 af = __bfloat1622float2(a);
                const bool keep_lo = (pf.x <= 0.0f) & (af.x >= 1e-4f);
                const bool keep_hi = (pf.y <= 0.0f) & (af.y >= 1e-4f);
                a = __halves2bfloat162(keep_lo ? __low2bfloat16(a) : zero,
                                       keep_hi ? __high2bfloat16(a) : zero);
                acc[e] = __hadd2_rn(acc[e], __hmul2_rn(a, half));
            }
        }
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) out[b + e] = acc[e];
    }
}

template <typename K>
int allow_smem(K kernel, int bytes)
{
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int gs_op_elementwise(int op, const void* x, void* out, int n_it, int dep_row,
                                 void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const float* xp = (const float*)x;
    float* o = (float*)out;
    switch (op) {
    case OP_CUMPROD: elementwise_kernel<OP_CUMPROD><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row); break;
    case OP_VPU9: elementwise_kernel<OP_VPU9><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row); break;
    case OP_EXP: elementwise_kernel<OP_EXP><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row); break;
    case OP_DIV: elementwise_kernel<OP_DIV><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int gs_op_contract4(const void* dpix, const void* feat, void* out, int fused, int n_it,
                               int dep_row, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    if (fused)
        contract4_kernel<true><<<1, BLOCK, 0, st>>>(
            (const float*)dpix, (const float*)feat, (float*)out, n_it, dep_row);
    else
        contract4_kernel<false><<<1, BLOCK, 0, st>>>(
            (const float*)dpix, (const float*)feat, (float*)out, n_it, dep_row);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_two_matmuls(const void* basis, const void* dpix, const void* x, const void* y,
                                 void* out, int n_it, int dep_row, void* stream)
{
    int err = allow_smem(two_matmuls_kernel, TWO_SMEM);
    if (err != 0) return err;
    two_matmuls_kernel<<<1, BLOCK, TWO_SMEM, (cudaStream_t)stream>>>(
        (const float*)basis, (const float*)dpix, (const float*)x, (const float*)y, (float*)out,
        n_it, dep_row);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_merged(const void* bd, const void* x, const void* y, void* out, int n_it,
                            int dep_row, int dep_col0, void* stream)
{
    int err = allow_smem(merged_kernel, MERGED_SMEM);
    if (err != 0) return err;
    merged_kernel<<<1, BLOCK, MERGED_SMEM, (cudaStream_t)stream>>>(
        (const float*)bd, (const float*)x, (const float*)y, (float*)out, n_it, dep_row, dep_col0);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_fwd_accum(const void* w, const void* feat, void* out, int n_it, int dep_col,
                               void* stream)
{
    fwd_accum_kernel<<<1, FA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)feat, (float*)out, n_it, dep_col);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_kappa(const void* basis, const void* q, void* out, int kappa, int n_it,
                           int dep_row, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const float* b = (const float*)basis;
    const float* qp = (const float*)q;
    float* o = (float*)out;
    switch (kappa) {
    case 1: kappa_kernel<1><<<1, BLOCK, 0, st>>>(b, qp, o, n_it, dep_row); break;
    case 2: kappa_kernel<2><<<1, BLOCK, 0, st>>>(b, qp, o, n_it, dep_row); break;
    case 4: kappa_kernel<4><<<1, BLOCK, 0, st>>>(b, qp, o, n_it, dep_row); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int gs_blend_mix_f32(const void* x, void* out, int n, int n_it, void* stream)
{
    blend_mix_f32_kernel<<<1, MIX_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n, n_it);
    return (int)cudaGetLastError();
}

extern "C" int gs_blend_mix_bf16(const void* x, void* out, int n, int n_it, void* stream)
{
    blend_mix_bf16_kernel<<<1, MIX_BLOCK, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat162*)x, (__nv_bfloat162*)out, n / 2, n_it);
    return (int)cudaGetLastError();
}
