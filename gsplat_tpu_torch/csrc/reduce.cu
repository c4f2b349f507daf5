// Kernel K4': per-gaussian gradient reduction, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_reduce_kernel` of gsplat_tpu/ops/reduce.py
// (:50, launched by `_run_reduce` from `reduce_by_gid`, :194-265). The TPU
// has no fast scatter-add, so the JAX package sorts the (16, K) per-instance
// gradient rows back by gaussian id and streams them through one-hot MXU
// matmuls into a rolling gaussian window. The GPU has atomics in L2, so the
// contract is computed directly, as the CUDA reference's backward does
// (`backward.cu:593-635`): one thread per (row, instance) adds its value
// into column gid of the (16, N) float32 output, for the ten meaningful
// rows. No sort-back and no window.
//
// With `pack_bf16` each value is first rounded to bf16 (round to nearest
// even) and back, as the hybrid mode's bf16 pair packing does
// (`reduce.py:216-230`). Zero values are skipped: adding +0 or -0 to a sum
// that starts at +0 leaves it as it is.
//
// The order of the float32 additions into one column varies from run to
// run (atomics), as K4's does (its sort is unstable, `reduce.py:214-215`),
// so results agree with a sequential sum to rounding, not bit for bit.
//
// Bound on the card: bytes, 10 rows and a gid read per instance and
// 10 x N floats written; the atomics land in L2 at addresses spread over
// the gaussians of a tile. Reads are coalesced (consecutive threads take
// consecutive instances of one row).

#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void reduce_by_gid_kernel(
    const float* __restrict__ dinst,  // (rows >= 10, K), row stride K
    const int* __restrict__ gid,      // (K,)
    long long k, long long n, int rows, int pack_bf16,
    float* __restrict__ out)          // (16, N), zeroed by the caller
{
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)rows * k) return;
    const long long r = idx / k;
    const long long i = idx - r * k;
    float v = dinst[idx];
    if (pack_bf16) v = gs::round_bf16(v);
    if (v != 0.0f) atomicAdd(out + r * n + gid[i], v);
}

}  // namespace

extern "C" int gs_reduce_by_gid(
    const void* dinst, const void* gid, long long k, long long n, int rows,
    int pack_bf16, void* out, void* stream)
{
    const int threads = 256;
    const long long blocks = ((long long)rows * k + threads - 1) / threads;
    reduce_by_gid_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)dinst, (const int*)gid, k, n, rows, pack_bf16, (float*)out);
    return (int)cudaGetLastError();
}
