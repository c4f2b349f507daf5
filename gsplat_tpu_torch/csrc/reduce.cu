// Kernel K4': per-gaussian gradient reduction, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_reduce_kernel` of gsplat_tpu/ops/reduce.py
// (:50, launched by `_run_reduce` from `reduce_by_gid`, :194-265). The TPU
// has no fast scatter-add, so the JAX package sorts the (16, K) per-instance
// gradient rows back by gaussian id and streams them through one-hot MXU
// matmuls into a rolling gaussian window. The GPU has atomics in L2, so the
// contract is computed directly, as the CUDA reference's backward does
// (`backward.cu:593-635`), with no sort-back and no window.
//
// One thread per instance reads its ten gradient rows (consecutive threads
// take consecutive instances of a row: coalesced) and its gid, once, and
// adds the ten values into row gid of a gaussian-major (N, 16) float32
// accumulator with three vector reductions of Hopper (`red.global.add`,
// PTX ISA 8.1, sm_90): v4 on columns 0-3 and 4-7, v2 on columns 8-9. The
// three land in one 64-byte line, where ten scalar atomics into a (16, N)
// output touched ten lines N floats apart. The wrapper returns the (16, N)
// view of the accumulator.
//
// With `pack_bf16` each value is first rounded to bf16 (round to nearest
// even) and back, as the hybrid mode's bf16 pair packing does
// (`reduce.py:216-230`). A vector whose components are all zero is skipped:
// adding +0 or -0 to a sum that starts at +0 leaves it as it is.
//
// The order of the float32 additions into one entry varies from run to run
// (atomics), as K4's does (its sort is unstable, `reduce.py:214-215`), so
// results agree with a sequential sum to rounding, not bit for bit.
//
// Bound on the card: bytes, 10 rows and a gid read per instance and
// 10 x N floats written. `gs_red_forms` is a measurement aid, not on any
// path: it adds float4 rows into one float4 with scalar atomics or with the
// two vector forms, so a run can read what each form does with subnormals.

#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void red_add_v4(float* addr, float a, float b, float c, float d)
{
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ void red_add_v2(float* addr, float a, float b)
{
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
                 :: "l"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ bool any_nonzero(float a, float b)
{
    return a != 0.0f || b != 0.0f;
}

// one instantiation per `pack_bf16`, so each holds exactly its three
// reductions (the sass phase of chip_smoke.py counts them)
template <bool PACK_BF16>
__global__ void reduce_by_gid_kernel(
    const float* __restrict__ dinst,  // (>= 10, K), row stride K
    const int* __restrict__ gid,      // (K,)
    long long k,
    float* __restrict__ acc)          // (N, 16), zeroed by the caller
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= k) return;
    float v[10];
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        v[r] = dinst[r * k + i];
        if (PACK_BF16) v[r] = gs::round_bf16(v[r]);
    }
    float* row = acc + 16 * (size_t)gid[i];
    if (any_nonzero(v[0], v[1]) || any_nonzero(v[2], v[3]))
        red_add_v4(row, v[0], v[1], v[2], v[3]);
    if (any_nonzero(v[4], v[5]) || any_nonzero(v[6], v[7]))
        red_add_v4(row + 4, v[4], v[5], v[6], v[7]);
    if (any_nonzero(v[8], v[9]))
        red_add_v2(row + 8, v[8], v[9]);
}

// FORM 0: four scalar atomicAdd; 1: one v4 reduction; 2: two v2 reductions
template <int FORM>
__global__ void red_forms_kernel(const float4* __restrict__ addends, long long m,
                                 float* __restrict__ out)  // (4,), zeroed by the caller
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const float4 v = addends[i];
    if (FORM == 0) {
        atomicAdd(out + 0, v.x);
        atomicAdd(out + 1, v.y);
        atomicAdd(out + 2, v.z);
        atomicAdd(out + 3, v.w);
    } else if (FORM == 1) {
        red_add_v4(out, v.x, v.y, v.z, v.w);
    } else {
        red_add_v2(out, v.x, v.y);
        red_add_v2(out + 2, v.z, v.w);
    }
}

}  // namespace

extern "C" int gs_reduce_by_gid(
    const void* dinst, const void* gid, long long k, int pack_bf16, void* acc, void* stream)
{
    const int threads = 256;
    const long long blocks = (k + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (pack_bf16)
        reduce_by_gid_kernel<true><<<(unsigned int)blocks, threads, 0, s>>>(
            (const float*)dinst, (const int*)gid, k, (float*)acc);
    else
        reduce_by_gid_kernel<false><<<(unsigned int)blocks, threads, 0, s>>>(
            (const float*)dinst, (const int*)gid, k, (float*)acc);
    return (int)cudaGetLastError();
}

extern "C" int gs_red_forms(const void* addends, long long m, int form, void* out, void* stream)
{
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((m + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    const float4* a = (const float4*)addends;
    if (form == 0) red_forms_kernel<0><<<blocks, threads, 0, s>>>(a, m, (float*)out);
    else if (form == 1) red_forms_kernel<1><<<blocks, threads, 0, s>>>(a, m, (float*)out);
    else red_forms_kernel<2><<<blocks, threads, 0, s>>>(a, m, (float*)out);
    return (int)cudaGetLastError();
}
