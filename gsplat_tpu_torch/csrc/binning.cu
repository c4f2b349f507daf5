// Kernel K1': tile binning for the sorted blend, on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_expand_kernel` of gsplat_tpu/ops/binning.py
// (:485, launched by `_expand_instances` from `pack_bins`). On the TPU that
// kernel run-length-decodes instance slots with a one-hot window matmul,
// because the TPU has no cheap scatter; it emits sort keys and the ten blend
// attribute columns, which then ride one wide `lax.sort` as payload.
//
// On the GPU a scatter at a prefix-sum offset is cheap, so the work splits
// around the sort (`torch.sort(stable=True)` in the wrapper) into two kernels:
//
//   gs_expand_instances  one thread per gaussian writes its `tiles_post`
//                        slots at offset `cum_excl` (the CUDA reference's
//                        duplicateWithKeys), decoding (tx, ty) from the tile
//                        rect, or from the row runs under tight_cull
//                        (RUN_HMAX = 8, binning.py:556-574). Key per slot:
//                        (tile << 32) | depth_bits; payload: the gid. Slots
//                        are in gid order, so a stable sort gives the JAX
//                        order (tile, depth bits, gid).
//   gs_pack_instances    one thread per sorted slot gathers its gaussian's
//                        columns into the (16, K) float32 instance table
//                        (conic pre-folded to [-a/2, -b, -c/2], invz =
//                        1/max(depth, 0.2)) and writes the tile boundaries.
//                        `mode` is the packet mode: 0 float32 (every row
//                        exact); 1 hybrid (the training default,
//                        binning.py:737-795), the folded conic, opacity and
//                        rgb rows 2-8 rounded to bf16 (nearest even) after
//                        the fold, as the JAX package's bf16 pair packing
//                        leaves them, mean2d and invz exact; 2 bfloat16
//                        (binning.py:743-746), all ten rows rounded,
//                        mean2d and invz (computed in float32 first)
//                        included. Rounded values are stored as float32.
//
// Bound on the card: bytes. Both kernels do a few integer operations per
// byte they move. Expand writes 12 bytes per instance with neighbouring
// threads of a warp writing to neighbouring gaussians' runs (runs are short:
// a few tiles each), so its stores are near-contiguous. Pack reads each
// sorted slot's key and permutation coalesced and gathers 40 bytes of
// per-gaussian columns by gid (a random gather, served largely from L2: the
// columns of 1M gaussians are 40 MB); its 16-row table stores are coalesced.
//
// Every value is copied or computed with exact integer or IEEE float32
// operations (built with -fmad=false), and rounded to bf16 the one way the
// JAX package rounds, so the result equals the JAX package's bit for bit.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int RUN_HMAX = 8;
constexpr int N_ROWS = 16;

__global__ void expand_instances_kernel(
    const int* __restrict__ rect,          // (N, 4) rmin_x, rmin_y, rect_w, tiles_post
    const long long* __restrict__ cum_excl,  // (N,)
    const unsigned char* __restrict__ trimmed,  // (N,)
    const int* __restrict__ t_lo,          // (N, 8) first tile column per row
    const int* __restrict__ cum_run,       // (N, 8) exclusive run-length prefix
    const float* __restrict__ depth,       // (N,)
    int n, int grid_x, int tight_cull,
    long long* __restrict__ keys,          // (K,)
    int* __restrict__ gids)                // (K,)
{
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    const int count = rect[4 * g + 3];
    if (count <= 0) return;
    const int rmin_x = rect[4 * g + 0];
    const int rmin_y = rect[4 * g + 1];
    const int rect_w = rect[4 * g + 2];
    const long long base = cum_excl[g];
    // valid rows have depth > 0.2: positive float bits, monotone as integers
    const long long dbits = (long long)(unsigned int)__float_as_int(depth[g]);

    if (tight_cull && trimmed[g]) {
        // run-trimmed decode: row r holds run_len(r) = cum_run[r+1] - cum_run[r]
        // tiles from column t_lo[r]; rows past the rect carry the total
        const int* tl = t_lo + RUN_HMAX * g;
        const int* cr = cum_run + RUN_HMAX * g;
        for (int r = 0; r < RUN_HMAX; ++r) {
            const int c0 = cr[r];
            const int c1 = (r + 1 < RUN_HMAX) ? cr[r + 1] : count;
            const long long ty = rmin_y + r;
            for (int j = 0; j < c1 - c0; ++j) {
                const long long tile = ty * grid_x + (tl[r] + j);
                const long long s = base + c0 + j;
                keys[s] = (tile << 32) | dbits;
                gids[s] = g;
            }
        }
    } else {
        // rect decode, slot by slot as in binning.py:548-554
        const int rw = rect_w > 1 ? rect_w : 1;
        for (int local = 0; local < count; ++local) {
            const int ly = local / rw;
            const long long tile = (long long)(rmin_y + ly) * grid_x + (rmin_x + local - ly * rw);
            const long long s = base + local;
            keys[s] = (tile << 32) | dbits;
            gids[s] = g;
        }
    }
}

__global__ void pack_instances_kernel(
    const long long* __restrict__ keys_sorted,  // (K,)
    const long long* __restrict__ perm,         // (K,) sort permutation
    const int* __restrict__ gids,               // (K,) unsorted slot gids
    const float* __restrict__ mean2d,           // (N, 2)
    const float* __restrict__ conic,            // (N, 3)
    const float* __restrict__ opacity,          // (N,)
    const float* __restrict__ rgb,              // (N, 3)
    const float* __restrict__ depth,            // (N,)
    long long k, int num_tiles, int mode,
    float* __restrict__ inst_t,                 // (16, K)
    int* __restrict__ gauss_id,                 // (K,)
    int* __restrict__ tile_id,                  // (K,)
    int* __restrict__ bounds)                   // (T+1,)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i > k) return;

    // tile boundaries: bounds[t] = first sorted slot with tile >= t. Thread i
    // owns every t in (tile[i-1], tile[i]], with tile[-1] = -1 and
    // tile[K] = num_tiles, so each entry is written exactly once and empty
    // tiles get start == end, as a searchsorted gives.
    const int prev = (i == 0) ? -1 : (int)(keys_sorted[i - 1] >> 32);
    const int cur = (i == k) ? num_tiles : (int)(keys_sorted[i] >> 32);
    for (int t = prev + 1; t <= cur; ++t) bounds[t] = (int)i;
    if (i == k) return;

    const int g = gids[perm[i]];
    gauss_id[i] = g;
    tile_id[i] = cur;
    const float vals[10] = {
        mean2d[2 * g + 0], mean2d[2 * g + 1],
        -0.5f * conic[3 * g + 0], -conic[3 * g + 1], -0.5f * conic[3 * g + 2],
        opacity[g], rgb[3 * g + 0], rgb[3 * g + 1], rgb[3 * g + 2],
        1.0f / fmaxf(depth[g], 0.2f),
    };
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const bool rounded = mode == 2 || (mode == 1 && r >= 2 && r <= 8);
        inst_t[r * k + i] = rounded ? gs::round_bf16(vals[r]) : vals[r];
    }
#pragma unroll
    for (int r = 10; r < N_ROWS; ++r) inst_t[r * k + i] = 0.0f;
}

}  // namespace

extern "C" int gs_expand_instances(
    const void* rect, const void* cum_excl, const void* trimmed, const void* t_lo,
    const void* cum_run, const void* depth, int n, int grid_x, int tight_cull,
    void* keys, void* gids, void* stream)
{
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    expand_instances_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)rect, (const long long*)cum_excl, (const unsigned char*)trimmed,
        (const int*)t_lo, (const int*)cum_run, (const float*)depth, n, grid_x,
        tight_cull, (long long*)keys, (int*)gids);
    return (int)cudaGetLastError();
}

extern "C" int gs_pack_instances(
    const void* keys_sorted, const void* perm, const void* gids, const void* mean2d,
    const void* conic, const void* opacity, const void* rgb, const void* depth,
    long long k, int num_tiles, int mode, void* inst_t, void* gauss_id,
    void* tile_id, void* bounds, void* stream)
{
    const int threads = 256;
    const long long blocks = (k + 1 + threads - 1) / threads;  // K + 1 threads
    pack_instances_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys_sorted, (const long long*)perm, (const int*)gids,
        (const float*)mean2d, (const float*)conic, (const float*)opacity,
        (const float*)rgb, (const float*)depth, k, num_tiles, mode, (float*)inst_t,
        (int*)gauss_id, (int*)tile_id, (int*)bounds);
    return (int)cudaGetLastError();
}
