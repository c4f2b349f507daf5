// Probes P1' and P2': the streaming skeletons of K2' and K3', on Hopper (sm_90a).
//
// Replace the Pallas kernels `_skel_fwd_kernel` (P1) and `_skel_bwd_kernel`
// (P2) of scripts/probe_ablate2.py (:32 and :52, launched by `run_skel_fwd`,
// :92, and `run_skel_bwd`, :112). Those are the TPU blend kernels with the
// chunk math dead: only the grid, the fetch loop and the emission are left.
// Here each skeleton is its CUDA blend kernel with the pair loop compiled
// out: P1' is K2' (rasterize_fwd.cu), P2' is K3' (rasterize_bwd.cu). Timed on
// the same inputs as the full kernel, a skeleton splits the kernel's time into
// the streaming machinery and the math.
//
// Both walk every tile's whole range: there is no early stop, as the
// probes' fori_loop has none (probe_ablate2.py:48,81). Write h_c =
// inst_t[0, 128 c] (the head of 128-aligned chunk c), base = s / 128 for tile
// t's range [s, e), and
//   acc(g) = sum_{c = base}^{g - 1} h_c * 1e-30
// in float32, in increasing c, each term added by one fused multiply-add
// (fmaf: one rounding). That is how XLA compiles the probes' `acc + h * 1e-30`
// on the CPU, where the JAX probes run in the tests (its LLVM target options
// always allow FP-op fusion). Then:
//   P1' (skel_fwd_kernel): out[t, :, :] = acc(ceil(e / 128)), broadcast over
//     (256, 8); 0 for an empty tile. This equals P1 bit for bit.
//   P2' (skel_bwd_kernel): dinst[r, j] = acc(j / 128) for every slot j of the
//     range and r < 10: the value P2 emits for j's chunk (:76-79). P2 hands a
//     chunk shared by two tiles from one grid step to the next (`_make_emit`,
//     rasterize_pallas.py:563-600), so on the columns of a tile's first chunk,
//     when s % 128 != 0, it adds the earlier tile's accumulator. Grid steps run
//     in order on a TPU and blocks here do not, so P2' writes 0 there. That
//     is the one deliberate difference.
//
// What is kept of K2' and K3': one block of 256 threads per tile; the staging
// of [s, e) into shared memory in batches (256 instances for P1', 64 for P2')
// of all ten table rows, with the kernels' barriers; for P2', K3''s prologue
// reads of the pixel's forward output and cotangent and its coalesced writes
// of ten rows per slot, each slot written once by its own tile's block, with
// no atomics. The staging stores and the prologue reads are volatile: nothing
// reads their values but the chunk heads, and the compiler would otherwise
// drop them as dead.
//
// Bound on the card: bytes. P1' moves K2''s bytes (ten rows per instance and
// two range ends per tile in, the (T, 256, 8) output out); P2' moves K3''s
// (the same rows and ranges plus the forward output and its cotangent in, ten
// rows per instance out). Their arithmetic is one fused multiply-add per
// chunk.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;

constexpr int CHUNK = 128;          // the TPU kernels' packet: 128 instances
constexpr float HEAD_SCALE = 1e-30f;
constexpr int BWD_BATCH = 64;       // K3''s batch
constexpr int N_GRAD = 10;

__global__ void __launch_bounds__(PPT) skel_fwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    float* __restrict__ out)           // (T, 256, 8)
{
    __shared__ float batch[N_ATTR][PPT];
    volatile float(*staged)[PPT] = batch;

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int s = tile_start[t];
    const int e = tile_end[t];
    const int base = s / CHUNK;

    float acc = 0.0f;
    // the first chunk's head lies before the range: read it from memory
    if (e > s && base * CHUNK < s) acc = fmaf(inst_t[(long long)base * CHUNK], HEAD_SCALE, acc);

    for (int b0 = s; b0 < e; b0 += PPT) {
        __syncthreads();  // the previous batch's readers are done
        const int nb = min(PPT, e - b0);
        if (tid < nb) {
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) staged[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        // the heads of the chunks that start inside this batch, in order
        for (int h = (b0 + CHUNK - 1) / CHUNK * CHUNK; h < b0 + nb; h += CHUNK)
            acc = fmaf(staged[0][h - b0], HEAD_SCALE, acc);
    }

    float* o = out + ((long long)t * PPT + tid) * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] = acc;
}

__global__ void __launch_bounds__(PPT) skel_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent
    float* __restrict__ dinst)         // (10, K)
{
    __shared__ float batch[N_ATTR][BWD_BATCH];
    volatile float(*staged)[BWD_BATCH] = batch;

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int s = tile_start[t];
    const int e = tile_end[t];

    // K3''s prologue reads: channels 0-4 of the pixel's forward output and
    // cotangent
    const volatile float* f = fwd + ((long long)t * PPT + tid) * 8;
    const volatile float* d = dout + ((long long)t * PPT + tid) * 8;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
        (void)f[c];
        (void)d[c];
    }

    // chunk g_cur holds the slots walked so far; acc = acc(g_cur), prev =
    // acc(g_cur - 1) for the slots of a batch that precede g_cur's start;
    // head = h_{g_cur} once read
    const int base = s / CHUNK;
    int g_cur = base;
    float acc = 0.0f, prev = 0.0f;
    float head = (e > s && base * CHUNK < s) ? inst_t[(long long)base * CHUNK] : 0.0f;

    for (int b0 = s; b0 < e; b0 += BWD_BATCH) {
        __syncthreads();  // the previous batch's readers are done
        const int nb = min(BWD_BATCH, e - b0);
        if (tid < nb) {
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) staged[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        // at most one chunk starts inside a batch of 64
        const int c = (b0 + CHUNK - 1) / CHUNK;
        if (c * CHUNK < b0 + nb) {
            if (c > g_cur) {
                prev = acc;
                acc = fmaf(head, HEAD_SCALE, acc);
                g_cur = c;
            }
            head = staged[0][c * CHUNK - b0];
        }
        __syncthreads();  // K3''s barrier before the row writes
        for (int idx = tid; idx < N_GRAD * nb; idx += PPT) {
            const int r = idx / nb;
            const int j = idx - r * nb;
            dinst[r * k + b0 + j] = (b0 + j) / CHUNK == g_cur ? acc : prev;
        }
    }
}

}  // namespace

extern "C" int gs_skel_fwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, void* out, void* stream)
{
    skel_fwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int gs_skel_bwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, const void* fwd, const void* dout, void* dinst, void* stream)
{
    skel_bwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        (const float*)fwd, (const float*)dout, (float*)dinst);
    return (int)cudaGetLastError();
}
