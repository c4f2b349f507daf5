// Adam over the Gaussian parameter rows, every field in one launch, on
// Hopper (sm_90a).
//
// Counterpart of the JAX package's `adam_update` (gsplat_tpu/train/optim.py
// :41) together with the train step's dead-row freeze
// (gsplat_tpu/train/step.py:159). Neither has a Pallas kernel: XLA fuses the
// update of each field under `jit`. Eager PyTorch ran it as ~15 elementwise
// launches per field and six more for the freeze, each reading and writing
// whole (N, width) arrays.
//
// `gs_adam_rows`: one block per 256 rows, all fields. The block first reads
// each row's step count (and its visibility and alive bytes), writes the new
// count, and computes the row's two bias corrections once, in shared memory
// (two `powf` per row, not per element). Then it walks the fields one after
// the other; a field's rows [r0, r0 + 256) are one contiguous run of p, m and
// v, read and written as float4 (16-byte loads and stores, neighbouring
// threads on neighbouring addresses) where every pointer is 16-byte aligned,
// element by element otherwise. The gradient is read where it lies, through
// its row stride (the projection backward's are rows of one buffer), one
// float at a time.
//
// The update of one element is the plain twin's (`adam_update_torch`,
// train/optim.py), operation for operation:
//   m' = 0.9 m + 0.1 g;  v' = 0.999 v + (0.001 g) g;
//   p' = p - (lr (m' / bc1)) / (sqrt(v' / bc2) + eps),
//   bc1 = 1 - 0.9^t, bc2 = 1 - 0.999^t, t = float(new count).
// A row outside `visibility` (sparse Adam) keeps p, m and v bit for bit; a
// dead row (`alive` false) keeps p bit for bit and takes the new moments, as
// the JAX step does. Outputs are written out of place: the checkpoint
// writer copies the submitted state on a side stream while the next step
// runs. Built with -fmad=false and without fast math, each operation rounds
// once as torch's CUDA kernels do (IEEE `/` and `sqrtf`; torch's `pow` of a
// scalar base calls the same `powf`), so the outputs equal the twin's bit
// for bit on the card. Constants are the twin's Python doubles rounded to
// float, as torch rounds a Python scalar.
//
// Bound on the card: bytes. Per row of the 59-float Gaussian layout it reads
// p, g, m and v (944 B) and writes p, m and v (708 B), plus the count (read
// and written) and the alive and visibility bytes. The ~15 float operations
// per element are far below the FP32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ADAM_MAX_FIELDS 8

struct AdamField {
    const float* p;   // (N, width) contiguous
    const float* g;   // rows g_stride floats apart, each row contiguous
    const float* m;
    const float* v;
    float* p_out;     // (N, width) contiguous, new buffers
    float* m_out;
    float* v_out;
    long long g_stride;
    int width;
    float lr;
};

struct AdamArgs {
    AdamField field[ADAM_MAX_FIELDS];
    const int* counts;                // (N,)
    int* counts_out;                  // (N,)
    const unsigned char* visibility;  // (N,) bool, or NULL: dense Adam
    const unsigned char* alive;       // (N,) bool, or NULL: no freeze
    long long n;
    int n_fields;
    float eps;
};

namespace {

constexpr int ROWS = 256;     // rows per block
constexpr int THREADS = 256;
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = (float)(1.0 - 0.9);    // the twin's `1.0 - ADAM_B1`
constexpr float OMB2 = (float)(1.0 - 0.999);

constexpr unsigned char UPDATE = 1, LIVE = 2;

__device__ __forceinline__ void adam_element(float p, float g, float m, float v, float lr,
                                             float eps, float bc1, float bc2,
                                             unsigned char flags, float& po, float& mo,
                                             float& vo)
{
    if (!(flags & UPDATE)) {
        po = p; mo = m; vo = v;
        return;
    }
    const float mn = B1 * m + OMB1 * g;
    const float vn = B2 * v + OMB2 * g * g;
    const float mb = mn / bc1;
    const float vb = vn / bc2;
    const float pn = p - lr * mb / (sqrtf(vb) + eps);
    po = (flags & LIVE) ? pn : p;
    mo = mn;
    vo = vn;
}

__device__ __forceinline__ bool aligned16(const void* a)
{
    return ((uintptr_t)a & 15) == 0;
}

__device__ __forceinline__ void update_field(const AdamField& f, long long r0, int rows,
                                             float eps, const float* s_bc1,
                                             const float* s_bc2, const unsigned char* s_flags)
{
    const int w = f.width;
    const int nel = rows * w;
    const long long base = r0 * w;  // the block's first element: a multiple of 4
    const float* __restrict__ p = f.p + base;
    const float* __restrict__ m = f.m + base;
    const float* __restrict__ v = f.v + base;
    float* __restrict__ po = f.p_out + base;
    float* __restrict__ mo = f.m_out + base;
    float* __restrict__ vo = f.v_out + base;

    auto one = [&](int j, float pj, float mj, float vj, float& a, float& b, float& c) {
        const int lr_ = j / w;
        const float g = f.g[(r0 + lr_) * f.g_stride + (j - lr_ * w)];
        adam_element(pj, g, mj, vj, f.lr, eps, s_bc1[lr_], s_bc2[lr_], s_flags[lr_], a, b, c);
    };

    if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(po) && aligned16(mo)
        && aligned16(vo)) {
        for (int j = 4 * threadIdx.x; j < nel; j += 4 * THREADS) {
            if (j + 4 <= nel) {
                const float4 p4 = *reinterpret_cast<const float4*>(p + j);
                const float4 m4 = *reinterpret_cast<const float4*>(m + j);
                const float4 v4 = *reinterpret_cast<const float4*>(v + j);
                float4 a, b, c;
                one(j, p4.x, m4.x, v4.x, a.x, b.x, c.x);
                one(j + 1, p4.y, m4.y, v4.y, a.y, b.y, c.y);
                one(j + 2, p4.z, m4.z, v4.z, a.z, b.z, c.z);
                one(j + 3, p4.w, m4.w, v4.w, a.w, b.w, c.w);
                *reinterpret_cast<float4*>(po + j) = a;
                *reinterpret_cast<float4*>(mo + j) = b;
                *reinterpret_cast<float4*>(vo + j) = c;
            } else {
                for (int q = j; q < nel; ++q)
                    one(q, p[q], m[q], v[q], po[q], mo[q], vo[q]);
            }
        }
    } else {
        for (int j = threadIdx.x; j < nel; j += THREADS)
            one(j, p[j], m[j], v[j], po[j], mo[j], vo[j]);
    }
}

__global__ void __launch_bounds__(THREADS) adam_rows_kernel(const AdamArgs a)
{
    __shared__ float s_bc1[ROWS], s_bc2[ROWS];
    __shared__ unsigned char s_flags[ROWS];

    const long long r0 = (long long)blockIdx.x * ROWS;
    const int rows = (int)min((long long)ROWS, a.n - r0);
    for (int i = threadIdx.x; i < rows; i += THREADS) {
        const long long r = r0 + i;
        const int step = a.visibility ? (int)(a.visibility[r] != 0) : 1;
        const int c = a.counts[r] + step;
        a.counts_out[r] = c;
        const float t = (float)c;
        s_bc1[i] = 1.0f - powf(B1, t);
        s_bc2[i] = 1.0f - powf(B2, t);
        s_flags[i] = (step ? UPDATE : 0) | ((!a.alive || a.alive[r]) ? LIVE : 0);
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < ADAM_MAX_FIELDS; ++f) {
        if (f < a.n_fields)
            update_field(a.field[f], r0, rows, a.eps, s_bc1, s_bc2, s_flags);
    }
}

}  // namespace

extern "C" int gs_adam_rows(const AdamArgs* a, void* stream)
{
    if (a->n_fields < 0 || a->n_fields > ADAM_MAX_FIELDS) return (int)cudaErrorInvalidValue;
    if (a->n <= 0) return 0;
    const long long blocks = (a->n + ROWS - 1) / ROWS;
    adam_rows_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
