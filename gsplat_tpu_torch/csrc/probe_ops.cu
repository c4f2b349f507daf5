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
// TPU core's VMEM block, so the probes' bound is one SM's peak. What bounds
// each kernel on the SM is the busiest of its pipes (issue, the FMA pipe,
// compares and logic, MUFU, shuffles, shared memory): `probes/floors.py`
// works the floors out from the built kernel's SASS.
//
// Dead code is the trap (probe_mm.py:4-8): only row 0 of a result is read
// again, so a compiler may compute the other rows only in the last iteration,
// or only under the branch that stores the fed-back row. Two guards:
//
// - the elementwise kernels (`k_cumprod`, `k_vpu9`, `k_exp`, `k_div`) take
//   the fed-back row as an argument, 0 at run time, and store every output
//   row in every iteration, unconditionally: the fed-back row to the next
//   iteration's buffer, the others to one trash slot in shared memory that
//   nothing reads (about two instructions per 4 outputs);
// - the others fold every output of every iteration into a register
//   checksum (one 3-input XOR per two outputs, no shared memory) that each
//   thread writes once after the loop to `sink`, a buffer the wrapper
//   allocates and drops. The fed-back row or column is then fixed (0).
//
// The last iteration is peeled and writes the result.
//
// P4' (blend_mix_*): per element, 2000 iterations of
//   x2 = acc * 0.5 + 1; p = -(x2 * x2) * 0.5; g = exp(p); a = min(x2 * g, 1);
//   keep = p <= 0 and a >= 1e-4 (compared in float32); a = keep ? a : 0;
//   acc = acc + a * 0.5
// from acc = x. The elements are independent, so a thread walks 8 of them
// together (for ILP) and no barrier is needed. The float32 kernel is plain
// float. The bf16 kernel keeps bf16 values two to a register
// (`__nv_bfloat162`) from load to store: each mul and add rounds to bf16 on
// its own (never fused), the min is packed, the exp is h2exp's arithmetic
// (below), and the keep compares run packed in bf16 against `thr`, the least
// bf16 whose float value is >= 1e-4f, which the wrapper passes: float(b) >=
// 1e-4f exactly when b >= thr, and float(b) <= 0 exactly when b <= 0 (a NaN
// fails both), as the JAX probe's float32 compares decide (:46-53).

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
constexpr int WARPS = BLOCK / 32;
constexpr int ROWS_PER_WARP = ROWS / WARPS;

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

// the checksum sink: two outputs into `cs` by one 3-input XOR
__device__ __forceinline__ unsigned fold(unsigned cs, float a, float b)
{
    return cs ^ __float_as_uint(a) ^ __float_as_uint(b);
}

// ------------------------------------------------------- elementwise (P3)
enum { OP_CUMPROD = 0, OP_VPU9 = 1, OP_EXP = 2, OP_DIV = 3, OP_DIV_EXACT = 4 };

// 1 / d, correctly rounded, for d in [1, 2): the approximate reciprocal
// (MUFU) and STEPS Newton steps as fused multiply-adds, e = 1 - d r, r = r +
// r e, the last of which is the residual correction (one step is exact on
// every float in [1, 2): `gs_rcp_check`, on the card). No slow path and no
// branch: `k_div` (OP_DIV) gathers the denominators' sign and exponent bits
// apart from those of [1, 2) and, if any was outside, runs the whole probe
// again after its loop with the IEEE division (OP_DIV_EXACT), in the same
// launch. So the kernel is right for any input, and the loop runs the
// reciprocal alone.
constexpr int RCP_STEPS = 1;

template <int STEPS>
__device__ __forceinline__ float rcp_1_2(float d)
{
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
        const float e = fmaf(-d, r, 1.0f);
        r = fmaf(e, r, r);
    }
    return r;
}

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
__device__ __forceinline__ void elementwise(float (&e)[4], const float (&x)[4], int lane,
                                            unsigned& off)
{
    if constexpr (OP == OP_CUMPROD) {
        cumprod_row(e, lane);
    } else if constexpr (OP == OP_DIV) {
        // 1 / (1.5 + v * 1e-3) by the reciprocal; `off` gathers each
        // denominator's bits that differ from those of [1, 2)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const float d = 1.5f + e[m] * 1e-3f;
            off |= __float_as_uint(d) ^ 0x3f800000u;
            e[m] = rcp_1_2<RCP_STEPS>(d);
        }
    } else if constexpr (OP == OP_DIV_EXACT) {
#pragma unroll
        for (int m = 0; m < 4; ++m) e[m] = 1.0f / (1.5f + e[m] * 1e-3f);
    } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float v = e[m];
            if constexpr (OP == OP_VPU9) {
#pragma unroll
                for (int j = 0; j < 3; ++j) v = v * x[m] + x[m];
                v = v * 1.0000001f;
            } else {
                v = expf(v * 1e-3f);
            }
            e[m] = v;
        }
    }
}

// `k_cumprod`, `k_vpu9`, `k_exp`, `k_div`: x (256, 128) -> (256, 128), each
// element of a result f(x + acc[0, col] * 1e-20); x lives in registers.
// Returns the bits `k_div` gathers from its denominators (0 for the others)
using DepRows = float4[2][LANES / 4];

template <int OP>
__device__ __forceinline__ unsigned elementwise_run(const float* __restrict__ x,
                                                    float* __restrict__ out, int n_it, int dep_row,
                                                    DepRows& dep, float4& trash)
{
    const int lane = threadIdx.x & 31;
    const int r0 = (threadIdx.x >> 5) * ROWS_PER_WARP;
    float4 xr[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
        xr[i] = reinterpret_cast<const float4*>(x)[(r0 + i) * (LANES / 4) + lane];
    if (threadIdx.x < 2 * LANES / 4) dep[threadIdx.x / 32][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    unsigned off = 0;
    auto step = [&](int it, auto last) {
        const float4 a = dep[it & 1][lane];
        const float sa[4] = {a.x * DEP_SCALE, a.y * DEP_SCALE, a.z * DEP_SCALE, a.w * DEP_SCALE};
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const float xe[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
            float e[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) e[m] = xe[m] + sa[m];
            elementwise<OP>(e, xe, lane, off);
            *(r0 + i == dep_row ? &dep[(it + 1) & 1][lane] : &trash) = f4(e);
            if constexpr (decltype(last)::value)
                reinterpret_cast<float4*>(out)[(r0 + i) * (LANES / 4) + lane] = f4(e);
        }
        __syncthreads();
    };
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    keep_trash(trash, out, dep_row);
    return off;
}

// `k_div` with the IEEE division, out of line: it runs only where a
// denominator left [1, 2)
__device__ __noinline__ void elementwise_exact(const float* __restrict__ x, float* __restrict__ out,
                                               int n_it, int dep_row, DepRows& dep, float4& trash)
{
    elementwise_run<OP_DIV_EXACT>(x, out, n_it, dep_row, dep, trash);
}

// `sink[0]` is `k_div`'s report: 1 where it reran with the IEEE division
// (the others ignore `sink`)
template <int OP>
__global__ void __launch_bounds__(BLOCK) elementwise_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n_it, int dep_row,
    unsigned* __restrict__ sink)
{
    __shared__ float4 dep[2][LANES / 4];
    __shared__ float4 trash;
    const unsigned off = elementwise_run<OP>(x, out, n_it, dep_row, dep, trash);
    if constexpr (OP == OP_DIV) {
        const int exact = __syncthreads_or(off >> 23 != 0);
        if (exact) elementwise_exact(x, out, n_it, dep_row, dep, trash);
        if (threadIdx.x == 0) sink[0] = exact;
    }
}

// `k_div`'s reciprocal alone, to check it on every float in [1, 2)
__global__ void rcp_check_kernel(const float* __restrict__ x, float* __restrict__ out, int n)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = rcp_1_2<RCP_STEPS>(x[i]);
}

// --------------------------------------------------- mbarriers (P3 cvpu, cmatmul)
// A shared-memory barrier object: `arrive` counts down the current phase and
// releases the arriving thread's writes; `wait(parity)` returns once the
// phase of that parity has completed and acquires them. A wait that has
// not returned after MBAR_PATIENCE tries traps, so a fault in the protocol
// fails the launch instead of hanging the card.
constexpr unsigned MBAR_PATIENCE = 1u << 24;

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar)
{
    asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared.b64 st, [%0];\n\t}"
                 ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity)
{
    for (unsigned tries = 0;; ++tries) {
        unsigned done;
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (tries == MBAR_PATIENCE) __trap();
    }
}

// ------------------------------------------------ K = 4 contraction (P3)
// `k_cvpu` (FUSED = false: ((d0 f0 + d1 f1) + d2 f2) + d3 f3 as separate
// multiplies and adds) and `k_cmatmul` (FUSED = true: the same sum as fmaf):
// dpix (256, 4), feat (4, 128) -> (256, 128), with f = feat + sum(acc[0]) *
// 1e-20. Warp w holds its 16 rows of dpix in registers (no shared-memory
// traffic in the loop). Warp 0 computes row 0 first in each iteration, sums
// it in the order every warp used to, and publishes sum * 1e-20 through a
// double buffer guarded by mbarriers: `full[b]` (warp 0 wrote buffer b) and
// `empty[b]` (the other 15 warps have read it). So a warp waits for row 0
// of the previous iteration only, never for the whole block, and the warps
// run up to an iteration apart.
template <bool FUSED>
__global__ void __launch_bounds__(BLOCK) contract4_kernel(
    const float* __restrict__ dpix, const float* __restrict__ feat, float* __restrict__ out,
    unsigned* __restrict__ sink, int n_it)
{
    __shared__ float ss_buf[2];
    __shared__ unsigned long long full[2], empty[2];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int r0 = warp * ROWS_PER_WARP;
    float4 fr[4], d[ROWS_PER_WARP];
#pragma unroll
    for (int k = 0; k < 4; ++k) fr[k] = reinterpret_cast<const float4*>(feat)[k * (LANES / 4) + lane];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) d[i] = reinterpret_cast<const float4*>(dpix)[r0 + i];
    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            mbar_init(&full[b], 1);
            mbar_init(&empty[b], WARPS - 1);
        }
    }
    __syncthreads();

    float ss = 0.f;  // the fed-back sum times 1e-20 (the first iteration's acc is 0)
    unsigned cs = 0;
    auto step = [&](int it, auto last) {
        // iteration it reads buffer it & 1, written by warp 0 in iteration it - 1
        if (warp != 0 && it > 0) {
            mbar_wait(&full[it & 1], ((it - 1) >> 1) & 1);
            ss = ss_buf[it & 1];
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[it & 1]);
        }
        float f[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            f[k][0] = fr[k].x + ss;
            f[k][1] = fr[k].y + ss;
            f[k][2] = fr[k].z + ss;
            f[k][3] = fr[k].w + ss;
        }
        float ss_next = 0.f;
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            float c[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const float4 dd = d[i];
                if constexpr (FUSED)
                    c[m] = fmaf(dd.w, f[3][m], fmaf(dd.z, f[2][m], fmaf(dd.y, f[1][m], dd.x * f[0][m])));
                else
                    c[m] = ((dd.x * f[0][m] + dd.y * f[1][m]) + dd.z * f[2][m]) + dd.w * f[3][m];
            }
            if (i == 0 && warp == 0) {
                float sum = ((c[0] + c[1]) + c[2]) + c[3];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
                ss_next = sum * DEP_SCALE;
                // buffer (it + 1) & 1 was last read in iteration it - 1
                if (it >= 2) mbar_wait(&empty[(it + 1) & 1], ((it - 2) >> 1) & 1);
                if (lane == 0) {
                    ss_buf[(it + 1) & 1] = ss_next;
                    mbar_arrive(&full[(it + 1) & 1]);
                }
            }
            cs = fold(fold(cs, c[0], c[1]), c[2], c[3]);
            if constexpr (decltype(last)::value)
                reinterpret_cast<float4*>(out)[(r0 + i) * (LANES / 4) + lane] = f4(c);
        }
        if (warp == 0) ss = ss_next;
    };
#pragma unroll 1
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    sink[threadIdx.x] = cs;
}

// ---------------------------------------------- 256-deep contractions (P3)
// `k_two_matmuls` and `k_merged` split the 256 depths into 8 slices of 32,
// x's values of a thread's columns and depths in registers. A warp's lanes
// walk the same depth together, so each depth's row of basis / bd is a
// warp-uniform shared-memory read (two float4 and a float2) that feeds all
// the lane's columns; y comes as one load a lane. The slices' partial sums
// meet in shared memory, summed in slice order. `k_two_matmuls` runs 8
// warps: thread (l, q) takes the 4 columns 4l .. 4l + 3 over slice q =
// warp (128 values of x, 40 sums; 40 fmaf a depth).
constexpr int SLICES = 8;
constexpr int DEPTH = ROWS / SLICES;
constexpr int W_BLOCK = 32 * SLICES;  // 256 threads
constexpr int QUADS = LANES / 4;      // 32 column quads, one a lane

// shared memory of `k_two_matmuls`: y (256, 128); per depth basis (6),
// dpix (4) and 2 zeros; the partial sums (8, 10, 128); row 0 of the
// result; the threads' checksums
constexpr int TWO_SMEM = (ROWS * LANES + ROWS * 12 + SLICES * 10 * LANES + LANES + W_BLOCK) * 4;

// `k_two_matmuls`: mom = basis^T (x + acc[0] * 1e-20) (6, 128) and dfeat =
// dpix^T y (4, 128) -> (16, 128) [mom; dfeat; 0]
__global__ void __launch_bounds__(W_BLOCK) two_matmuls_kernel(
    const float* __restrict__ basis, const float* __restrict__ dpix, const float* __restrict__ x,
    const float* __restrict__ y, float* __restrict__ out, unsigned* __restrict__ sink, int n_it)
{
    extern __shared__ float4 smem4[];
    float* y_s = reinterpret_cast<float*>(smem4);
    float4* bd_s = reinterpret_cast<float4*>(y_s + ROWS * LANES);  // 3 per depth
    float* part = reinterpret_cast<float*>(bd_s + 3 * ROWS);
    float* dep = part + SLICES * 10 * LANES;
    unsigned* cs_s = reinterpret_cast<unsigned*>(dep + LANES);

    const int lane = threadIdx.x & 31;
    const int q = threadIdx.x >> 5;
    const int col = 4 * lane;
    float4 xr[DEPTH];
#pragma unroll
    for (int kk = 0; kk < DEPTH; ++kk)
        xr[kk] = *reinterpret_cast<const float4*>(x + (q * DEPTH + kk) * LANES + col);
    for (int i = threadIdx.x; i < ROWS * LANES / 4; i += W_BLOCK)
        reinterpret_cast<float4*>(y_s)[i] = reinterpret_cast<const float4*>(y)[i];
    for (int r = threadIdx.x; r < ROWS; r += W_BLOCK) {
        const float* b = basis + r * 6;
        const float4 dp = reinterpret_cast<const float4*>(dpix)[r];
        bd_s[3 * r] = make_float4(b[0], b[1], b[2], b[3]);
        bd_s[3 * r + 1] = make_float4(b[4], b[5], dp.x, dp.y);
        bd_s[3 * r + 2] = make_float4(dp.z, dp.w, 0.f, 0.f);
    }
    for (int i = threadIdx.x; i < LANES; i += W_BLOCK) dep[i] = 0.f;
    cs_s[threadIdx.x] = 0;
    __syncthreads();

    auto step = [&](auto last) {
        const float4 a = *reinterpret_cast<const float4*>(dep + col);
        const float sa[4] = {a.x * DEP_SCALE, a.y * DEP_SCALE, a.z * DEP_SCALE, a.w * DEP_SCALE};
        float acc[10][4];
#pragma unroll
        for (int r = 0; r < 10; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DEPTH; ++kk) {
            const int k = q * DEPTH + kk;
            const float xk[4] = {xr[kk].x + sa[0], xr[kk].y + sa[1], xr[kk].z + sa[2],
                                 xr[kk].w + sa[3]};
            const float4 b0 = bd_s[3 * k], b1 = bd_s[3 * k + 1];
            const float2 b2 = *reinterpret_cast<const float2*>(bd_s + 3 * k + 2);
            const float4 yy = *reinterpret_cast<const float4*>(y_s + k * LANES + col);
            const float yk[4] = {yy.x, yy.y, yy.z, yy.w};
            const float b[10] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int r = 0; r < 6; ++r) acc[r][j] = fmaf(b[r], xk[j], acc[r][j]);
#pragma unroll
                for (int r = 6; r < 10; ++r) acc[r][j] = fmaf(b[r], yk[j], acc[r][j]);
            }
        }
#pragma unroll
        for (int r = 0; r < 10; ++r)
            *reinterpret_cast<float4*>(part + (q * 10 + r) * LANES + col) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        __syncthreads();
        unsigned cs = cs_s[threadIdx.x];
#pragma unroll
        for (int t = 0; t < (10 * QUADS + W_BLOCK - 1) / W_BLOCK; ++t) {  // (row, column quad)
            const int u = threadIdx.x + t * W_BLOCK;
            if (u >= 10 * QUADS) break;
            const int r = u / QUADS, c = 4 * (u % QUADS);
            float4 v = *reinterpret_cast<const float4*>(part + r * LANES + c);
#pragma unroll
            for (int s = 1; s < SLICES; ++s) {
                const float4 p = *reinterpret_cast<const float4*>(part + (s * 10 + r) * LANES + c);
                v.x = v.x + p.x;
                v.y = v.y + p.y;
                v.z = v.z + p.z;
                v.w = v.w + p.w;
            }
            cs = fold(fold(cs, v.x, v.y), v.z, v.w);
            if (r == 0) *reinterpret_cast<float4*>(dep + c) = v;
            if constexpr (decltype(last)::value) *reinterpret_cast<float4*>(out + r * LANES + c) = v;
        }
        cs_s[threadIdx.x] = cs;
        __syncthreads();
    };
#pragma unroll 1
    for (int it = 0; it < n_it - 1; ++it) step(NotLast{});
    step(Last{});
    for (int i = threadIdx.x; i < 6 * LANES; i += W_BLOCK) out[10 * LANES + i] = 0.f;
    sink[threadIdx.x] = cs_s[threadIdx.x];
}

// `k_merged` runs 16 warps: thread (g, q) takes the column pair 2g, 2g + 1
// (g = lane + 32 (warp & 1)) of both halves (x', y) over slice q = warp /
// 2, its 40 sums and x's 64 values of its columns: 104 of its 128
// registers. The 3 float4 of a depth's bd row feed 40 fmaf. So that nothing
// spills, x of the slice's first M_GLOBAL depths is read in every iteration
// from global memory (L1) instead of registers (8 warps with 4 columns
// each need about 250 registers and spill more)
constexpr int M_BLOCK = 512;
constexpr int M_PAIRS = LANES / 2;
constexpr int M_GLOBAL = 4;

// shared memory of `k_merged`: y (256, 128); bd (256, 10) padded to 12; the
// partial sums (8, 20, 128); row 0, columns 0-127 of the result; the
// threads' checksums
constexpr int MERGED_SMEM = (ROWS * LANES + ROWS * 12 + SLICES * 20 * LANES + LANES + M_BLOCK) * 4;

// `k_merged`: bd^T [x + acc[0, 0:128] * 1e-20 | y] (10, 256) -> (16, 256)
// [both; 0]. The checksum waits in shared memory between iterations
__global__ void __launch_bounds__(M_BLOCK) merged_kernel(
    const float* __restrict__ bd, const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, unsigned* __restrict__ sink, int n_it)
{
    extern __shared__ float4 smem4[];
    float* y_s = reinterpret_cast<float*>(smem4);
    float4* bd_s = reinterpret_cast<float4*>(y_s + ROWS * LANES);  // 3 per depth
    float* part = reinterpret_cast<float*>(bd_s + 3 * ROWS);
    float* dep = part + SLICES * 20 * LANES;
    unsigned* cs_s = reinterpret_cast<unsigned*>(dep + LANES);

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int col = 2 * (lane + 32 * (warp & 1));
    const int q = warp >> 1;
    const float* xq = x + q * DEPTH * LANES + col;
    float2 xr[DEPTH];
#pragma unroll
    for (int kk = M_GLOBAL; kk < DEPTH; ++kk) xr[kk] = *reinterpret_cast<const float2*>(xq + kk * LANES);
    for (int i = threadIdx.x; i < ROWS * LANES / 4; i += M_BLOCK)
        reinterpret_cast<float4*>(y_s)[i] = reinterpret_cast<const float4*>(y)[i];
    for (int r = threadIdx.x; r < ROWS; r += M_BLOCK) {
        const float* b = bd + r * 10;
        bd_s[3 * r] = make_float4(b[0], b[1], b[2], b[3]);
        bd_s[3 * r + 1] = make_float4(b[4], b[5], b[6], b[7]);
        bd_s[3 * r + 2] = make_float4(b[8], b[9], 0.f, 0.f);
    }
    for (int i = threadIdx.x; i < LANES; i += M_BLOCK) dep[i] = 0.f;
    cs_s[threadIdx.x] = 0;
    __syncthreads();

    auto step = [&](auto last) {
        asm volatile("" ::: "memory");  // the first depths' x is read again in every iteration
        const float2 a = *reinterpret_cast<const float2*>(dep + col);
        const float sa0 = a.x * DEP_SCALE, sa1 = a.y * DEP_SCALE;
        float ax[10][2], ay[10][2];
#pragma unroll
        for (int r = 0; r < 10; ++r) ax[r][0] = ax[r][1] = ay[r][0] = ay[r][1] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DEPTH; ++kk) {
            const int k = q * DEPTH + kk;
            const float2 xv = kk < M_GLOBAL ? __ldg(reinterpret_cast<const float2*>(xq + kk * LANES))
                                            : xr[kk];
            const float xk[2] = {xv.x + sa0, xv.y + sa1};
            const float2 yy = *reinterpret_cast<const float2*>(y_s + k * LANES + col);
            const float yk[2] = {yy.x, yy.y};
            const float4 b0 = bd_s[3 * k], b1 = bd_s[3 * k + 1];
            const float2 b2 = *reinterpret_cast<const float2*>(bd_s + 3 * k + 2);
            const float b[10] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y};
#pragma unroll
            for (int r = 0; r < 10; ++r) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    ax[r][j] = fmaf(b[r], xk[j], ax[r][j]);
                    ay[r][j] = fmaf(b[r], yk[j], ay[r][j]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < 10; ++r) {
            *reinterpret_cast<float2*>(part + (q * 20 + r) * LANES + col) = make_float2(ax[r][0], ax[r][1]);
            *reinterpret_cast<float2*>(part + (q * 20 + 10 + r) * LANES + col) =
                make_float2(ay[r][0], ay[r][1]);
        }
        __syncthreads();
        unsigned cs = cs_s[threadIdx.x];
#pragma unroll
        for (int t = 0; t < (20 * M_PAIRS + M_BLOCK - 1) / M_BLOCK; ++t) {  // ((row, half), pair)
            const int u = threadIdx.x + t * M_BLOCK;
            if (u >= 20 * M_PAIRS) break;
            const int idx = u / M_PAIRS, c = 2 * (u % M_PAIRS);
            float2 v = *reinterpret_cast<const float2*>(part + idx * LANES + c);
#pragma unroll
            for (int s = 1; s < SLICES; ++s) {
                const float2 p = *reinterpret_cast<const float2*>(part + (s * 20 + idx) * LANES + c);
                v.x = v.x + p.x;
                v.y = v.y + p.y;
            }
            cs = fold(cs, v.x, v.y);
            if (idx == 0) *reinterpret_cast<float2*>(dep + c) = v;
            if constexpr (decltype(last)::value) {
                const int r = idx % 10, col0 = idx < 10 ? 0 : LANES;
                *reinterpret_cast<float2*>(out + r * 2 * LANES + col0 + c) = v;
            }
        }
        cs_s[threadIdx.x] = cs;
        __syncthreads();
    };
#pragma unroll 1
    for (int it = 0; it < n_it - 1; ++it) step(NotLast{});
    step(Last{});
    for (int i = threadIdx.x; i < 6 * 2 * LANES; i += M_BLOCK) out[10 * 2 * LANES + i] = 0.f;
    sink[threadIdx.x] = cs_s[threadIdx.x];
}

// `k_fwd_accum`: (w + acc[:, 0] * 1e-20) feat^T (256, 4) -> (256, 128)
// [a, 0]. Each output is the sum of the four residues k mod 4, each summed
// over k in order, ((s0 + s1) + (s2 + s3)). Warp w takes half h = w / 4 of
// the residues (2h, 2h + 1) for 64 row pairs, lane l rows 2p, 2p + 1 (p =
// 32 (w % 4) + l), their 128 values of w in registers: every lane reads
// feat[:, k] together, one warp-uniform float4 for 16 fmaf of two rows. The
// two halves of a row pair meet through a double buffer in shared memory
// behind a barrier of the two warps (ids 1-4), so no block-wide barrier
// runs and each row's feedback needs only its pair.
constexpr int FA_BLOCK = 256;

__device__ __forceinline__ void pair_barrier(int id)
{
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(FA_BLOCK) fwd_accum_kernel(
    const float* __restrict__ w, const float* __restrict__ feat, float* __restrict__ out,
    unsigned* __restrict__ sink, int n_it)
{
    __shared__ float4 feat_s[LANES];          // feat_s[k] = feat[0:4, k]
    __shared__ float4 half_s[2][2][128][2];   // [buffer][half][row pair][row]: a half's sums
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int h = warp >> 2;
    const int p = 32 * (warp & 3) + lane;
    float wr[2][64];  // wr[i][2 kk + j] = w[2p + i, 4 kk + 2h + j]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) {
            const float2 v = *reinterpret_cast<const float2*>(w + (2 * p + i) * LANES + 4 * kk + 2 * h);
            wr[i][2 * kk] = v.x;
            wr[i][2 * kk + 1] = v.y;
        }
    for (int k = threadIdx.x; k < LANES; k += FA_BLOCK)
        feat_s[k] = make_float4(feat[k], feat[LANES + k], feat[2 * LANES + k], feat[3 * LANES + k]);
    __syncthreads();

    float o0[2] = {0.f, 0.f};  // column 0 of the rows' last results
    unsigned cs = 0;
    auto step = [&](int it, auto last) {
        float n[2][2][4];  // [row][residue 2h + j][column]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) n[i][j][0] = n[i][j][1] = n[i][j][2] = n[i][j][3] = 0.f;
        const float sa[2] = {o0[0] * DEP_SCALE, o0[1] * DEP_SCALE};
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float4 f = feat_s[4 * kk + 2 * h + j];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float wk = wr[i][2 * kk + j] + sa[i];
                    n[i][j][0] = fmaf(wk, f.x, n[i][j][0]);
                    n[i][j][1] = fmaf(wk, f.y, n[i][j][1]);
                    n[i][j][2] = fmaf(wk, f.z, n[i][j][2]);
                    n[i][j][3] = fmaf(wk, f.w, n[i][j][3]);
                }
            }
        }
        float4 mine[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mine[i] = make_float4(n[i][0][0] + n[i][1][0], n[i][0][1] + n[i][1][1],
                                  n[i][0][2] + n[i][1][2], n[i][0][3] + n[i][1][3]);
            half_s[it & 1][h][p][i] = mine[i];
        }
        pair_barrier(1 + (warp & 3));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float4 other = half_s[it & 1][h ^ 1][p][i];
            const float o[4] = {mine[i].x + other.x, mine[i].y + other.y, mine[i].z + other.z,
                                mine[i].w + other.w};
            o0[i] = o[0];
            cs = fold(fold(cs, o[0], o[1]), o[2], o[3]);
            if constexpr (decltype(last)::value)
                if (h == 0) reinterpret_cast<float4*>(out)[(2 * p + i) * (LANES / 4)] = f4(o);
        }
    };
#pragma unroll 1
    for (int it = 0; it < n_it - 1; ++it) step(it, NotLast{});
    step(n_it - 1, Last{});
    for (int i = threadIdx.x; i < ROWS * LANES; i += FA_BLOCK)
        if (i % LANES >= 4) out[i] = 0.f;
    sink[threadIdx.x] = cs;
}

// `make_kappa(KAPPA)`: basis (256, 8) (q + acc[0] * 1e-20) -> (256, 128 KAPPA),
// each output a sum of 8 products. A column's feedback is its own row 0, so
// the columns split over the warps with no barrier: warp w takes the C = 8
// KAPPA columns [w C, w C + C), lane l the rows 8 l .. 8 l + 7, whose basis
// values (64) stay in registers. Each iteration the warp stages q' = q + sa
// of its columns in shared memory (2 KAPPA values a lane); then every column
// is two warp-uniform float4 reads that feed 64 fmaf a lane, and lane 0
// keeps row 0 times 1e-20 for the next staging
template <int KAPPA>
__global__ void __launch_bounds__(BLOCK) kappa_kernel(
    const float* __restrict__ basis, const float* __restrict__ q, float* __restrict__ out,
    unsigned* __restrict__ sink, int n_it)
{
    constexpr int NC = LANES * KAPPA;       // output columns
    constexpr int C = NC / WARPS;           // a warp's columns
    constexpr int STAGED = 8 * C / 32;      // q' values a lane stages
    __shared__ float4 qp_s[WARPS][C][2];    // q'[0:8, c] of each warp's columns
    __shared__ float sa_s[WARPS][C];        // row 0 of the last result times 1e-20
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c0 = warp * C;
    float b[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float4 v0 = reinterpret_cast<const float4*>(basis)[2 * (8 * lane + j)];
        const float4 v1 = reinterpret_cast<const float4*>(basis)[2 * (8 * lane + j) + 1];
        b[j][0] = v0.x; b[j][1] = v0.y; b[j][2] = v0.z; b[j][3] = v0.w;
        b[j][4] = v1.x; b[j][5] = v1.y; b[j][6] = v1.z; b[j][7] = v1.w;
    }
    float qv[STAGED];  // q[k, c0 + c] for the lane's staged (k, c): i = lane + 32 t, c = i / 8, k = i % 8
#pragma unroll
    for (int t = 0; t < STAGED; ++t) {
        const int i = lane + 32 * t;
        qv[t] = q[(i % 8) * NC + c0 + i / 8];
    }
    for (int c = lane; c < C; c += 32) sa_s[warp][c] = 0.f;
    __syncwarp();

    float* qp = reinterpret_cast<float*>(qp_s[warp]);
    unsigned cs = 0;
    auto step = [&](auto last) {
#pragma unroll
        for (int t = 0; t < STAGED; ++t) {
            const int i = lane + 32 * t;
            qp[i] = qv[t] + sa_s[warp][i / 8];
        }
        __syncwarp();
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
            const float4 q0 = qp_s[warp][cc][0], q1 = qp_s[warp][cc][1];
            const float qk[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
            float p[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                p[j] = b[j][0] * qk[0];
#pragma unroll
                for (int k = 1; k < 8; ++k) p[j] = fmaf(b[j][k], qk[k], p[j]);
            }
#pragma unroll
            for (int j = 0; j < 8; j += 2) cs = fold(cs, p[j], p[j + 1]);
            if (lane == 0) sa_s[warp][cc] = p[0] * DEP_SCALE;
            if constexpr (decltype(last)::value) {
#pragma unroll
                for (int j = 0; j < 8; ++j) out[(8 * lane + j) * NC + c0 + cc] = p[j];
            }
        }
        __syncwarp();
    };
#pragma unroll 1
    for (int it = 0; it < n_it - 1; ++it) step(NotLast{});
    step(Last{});
    sink[threadIdx.x] = cs;
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

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 v)
{
    return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(unsigned u)
{
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// exp of both halves with h2exp's arithmetic: each half widened to float by
// a shift, times h2exp's constant 0x3FB8AA3C, ex2.approx, both rounded to
// bf16 by one packed conversion. ex2 runs in its flush-to-zero form, one MUFU
// a half with no range fix-up: it differs from h2exp only where the result
// is below 2^-126, and there a = min(x2 g, 1) stays under 1e-4 (x2 >= 13.2
// whenever p < -87.3) or is negative, so the gate zeroes it either way and
// no output changes
__device__ __forceinline__ __nv_bfloat162 exp_bf16x2(__nv_bfloat162 v)
{
    const unsigned u = bf2_bits(v);
    float lo = __uint_as_float(u << 16) * __uint_as_float(0x3FB8AA3Cu);
    float hi = __uint_as_float(u & 0xffff0000u) * __uint_as_float(0x3FB8AA3Cu);
    asm("ex2.approx.ftz.f32 %0, %0;" : "+f"(lo));
    asm("ex2.approx.ftz.f32 %0, %0;" : "+f"(hi));
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return bits_bf2(r);
}

__global__ void __launch_bounds__(MIX_BLOCK) blend_mix_bf16_kernel(
    const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out, int n2, int n_it,
    unsigned short thr)
{
    const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
    const __nv_bfloat162 neg_half = __float2bfloat162_rn(-0.5f);
    const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
    const __nv_bfloat162 thr2 = bits_bf2(thr | (unsigned)thr << 16);
    for (int b = threadIdx.x * MIX_ILP; b < n2; b += MIX_BLOCK * MIX_ILP) {
        __nv_bfloat162 acc[MIX_ILP];
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) acc[e] = x[b + e];
#pragma unroll 1
        for (int it = 0; it < n_it; ++it) {
#pragma unroll
            for (int e = 0; e < MIX_ILP; ++e) {
                const __nv_bfloat162 x2 = __hadd2_rn(__hmul2_rn(acc[e], half), one);
                // -(x2 * x2) * 0.5 is (x2 * x2) * -0.5: the negation rounds nothing
                const __nv_bfloat162 p = __hmul2_rn(__hmul2_rn(x2, x2), neg_half);
                const __nv_bfloat162 g = exp_bf16x2(p);
                const __nv_bfloat162 a = __hmin2(__hmul2_rn(x2, g), one);
                const unsigned keep = __hle2_mask(p, zero) & __hge2_mask(a, thr2);
                const __nv_bfloat162 kept = bits_bf2(bf2_bits(a) & keep);  // +0 where not kept
                acc[e] = __hadd2_rn(acc[e], __hmul2_rn(kept, half));
            }
        }
#pragma unroll
        for (int e = 0; e < MIX_ILP; ++e) out[b + e] = acc[e];
    }
}

// the SM clock while one block spins: clock64 cycles over %globaltimer
// nanoseconds, out[0] cycles and out[1] nanoseconds
__global__ void sm_clock_kernel(unsigned long long* out, long long spin)
{
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    const long long c0 = clock64();
    while (clock64() - c0 < spin) {
    }
    const long long c1 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = t1 - t0;
}

template <typename K>
int allow_smem(K kernel, int bytes)
{
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int gs_op_elementwise(int op, const void* x, void* out, void* sink, int n_it,
                                 int dep_row, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const float* xp = (const float*)x;
    float* o = (float*)out;
    unsigned* f = (unsigned*)sink;
    switch (op) {
    case OP_CUMPROD: elementwise_kernel<OP_CUMPROD><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row, f); break;
    case OP_VPU9: elementwise_kernel<OP_VPU9><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row, f); break;
    case OP_EXP: elementwise_kernel<OP_EXP><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row, f); break;
    case OP_DIV: elementwise_kernel<OP_DIV><<<1, BLOCK, 0, st>>>(xp, o, n_it, dep_row, f); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int gs_rcp_check(const void* x, void* out, int n, void* stream)
{
    rcp_check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_contract4(const void* dpix, const void* feat, void* out, void* sink, int fused,
                               int n_it, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    if (fused)
        contract4_kernel<true><<<1, BLOCK, 0, st>>>(
            (const float*)dpix, (const float*)feat, (float*)out, (unsigned*)sink, n_it);
    else
        contract4_kernel<false><<<1, BLOCK, 0, st>>>(
            (const float*)dpix, (const float*)feat, (float*)out, (unsigned*)sink, n_it);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_two_matmuls(const void* basis, const void* dpix, const void* x, const void* y,
                                 void* out, void* sink, int n_it, void* stream)
{
    const int err = allow_smem(two_matmuls_kernel, TWO_SMEM);
    if (err != 0) return err;
    two_matmuls_kernel<<<1, W_BLOCK, TWO_SMEM, (cudaStream_t)stream>>>(
        (const float*)basis, (const float*)dpix, (const float*)x, (const float*)y, (float*)out,
        (unsigned*)sink, n_it);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_merged(const void* bd, const void* x, const void* y, void* out, void* sink,
                            int n_it, void* stream)
{
    const int err = allow_smem(merged_kernel, MERGED_SMEM);
    if (err != 0) return err;
    merged_kernel<<<1, M_BLOCK, MERGED_SMEM, (cudaStream_t)stream>>>(
        (const float*)bd, (const float*)x, (const float*)y, (float*)out, (unsigned*)sink, n_it);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_fwd_accum(const void* w, const void* feat, void* out, void* sink, int n_it,
                               void* stream)
{
    fwd_accum_kernel<<<1, FA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)w, (const float*)feat, (float*)out, (unsigned*)sink, n_it);
    return (int)cudaGetLastError();
}

extern "C" int gs_op_kappa(const void* basis, const void* q, void* out, void* sink, int kappa,
                           int n_it, void* stream)
{
    const cudaStream_t st = (cudaStream_t)stream;
    const float* b = (const float*)basis;
    const float* qp = (const float*)q;
    float* o = (float*)out;
    unsigned* s = (unsigned*)sink;
    switch (kappa) {
    case 1: kappa_kernel<1><<<1, BLOCK, 0, st>>>(b, qp, o, s, n_it); break;
    case 2: kappa_kernel<2><<<1, BLOCK, 0, st>>>(b, qp, o, s, n_it); break;
    case 4: kappa_kernel<4><<<1, BLOCK, 0, st>>>(b, qp, o, s, n_it); break;
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

extern "C" int gs_blend_mix_bf16(const void* x, void* out, int n, int n_it, int thr, void* stream)
{
    if (thr < 0 || thr > 0xffff) return (int)cudaErrorInvalidValue;
    blend_mix_bf16_kernel<<<1, MIX_BLOCK, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat162*)x, (__nv_bfloat162*)out, n / 2, n_it, (unsigned short)thr);
    return (int)cudaGetLastError();
}

// what one warp's pass through each probe kernel's hot loop covers, for the
// floors of `probes/floors.py` (in its `SASS_PROBES` order): for a P3'
// kernel the warps that pass through it once an iteration, for a P4' kernel
// the elements a pass takes
extern "C" int gs_probe_loop_shape(int* out, int n)
{
    const int shape[] = {WARPS, WARPS, WARPS, WARPS, WARPS, WARPS, W_BLOCK / 32, M_BLOCK / 32,
                         FA_BLOCK / 32, WARPS, WARPS, WARPS, 32 * MIX_ILP, 32 * MIX_ILP * 2};
    if (n != (int)(sizeof(shape) / sizeof(shape[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = shape[i];
    return 0;
}

extern "C" int gs_sm_clock(void* out, long long spin, void* stream)
{
    sm_clock_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)out, spin);
    return (int)cudaGetLastError();
}
