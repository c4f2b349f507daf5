// Kernels K5' and K6': the order-independent (OIT) blend and its backward,
// on Hopper (sm_90a).
//
// Replace the Pallas kernels `_oit_fwd_kernel` (gsplat_tpu/ops/rasterize_pallas.py
// :897, launched by `_run_oit_forward`, :948) and `_oit_bwd_kernel` (:974,
// launched by `_run_oit_backward`, :1095) of the opt-in blend mode
// `RenderSettings.blend_mode = "oit"`. Per pixel, commutative sums over every
// kept (pixel, instance) pair of the pixel's tile replace the sorted blend's
// front-to-back recurrence (z = invz):
//   N = sum alpha z^2 [r, g, b, z],  D = sum alpha z^2,  T = exp(sum log1p(-alpha)).
// The quotient N / max(D, 1e-8) * (1 - T) is composed outside, in plain torch,
// and differentiated there by autograd (rasterize_pallas.py:1306-1324).
// Power, alpha and the keep rule are `gs::pair_power` and `gs::pair_alpha`
// (common.cuh), the functions the sorted kernels K2' and K3' call, built with
// -fmad=false: K6' sees exactly the pairs K5' kept.
//
// gs_oit_fwd (K5'): the shape of K2' (rasterize_fwd.cu). One block of 256
//   threads per 16x16 tile, one thread per pixel; the block stages its range
//   in batches of 256 instances (10 floats each, 10 KB of shared memory) and
//   every pixel walks each batch in order. No early stop and no stop test:
//   every pixel evaluates every instance of its tile. It writes
//   [N0, N1, N2, N3, D, expf(L), 0, 0] with L = sum log1pf(-alpha); an empty
//   tile writes N = D = 0 and T = 1.
//   Bound on the card: operations. Each evaluated pair costs ~11 float32
//   operations before the keep test and each kept pair ~18 more (expf and
//   log1pf counted as one each), against 40 bytes per instance read once per
//   tile and amortized over 256 pixels. Not done yet (later work): overlap
//   the next batch's loads with this batch's walk, or balance tiles of very
//   different range lengths across SMs.
//
// gs_oit_bwd (K6'): per-instance gradient rows from the cotangents of the raw
//   sums. With K = dN . [r, g, b, z] + dD and rT = dT * T_final (the
//   cotangent of L), a kept pair has
//     dalpha = z^2 K - rT / (1 - alpha),  dgm = op dalpha g,
//   and adds to its instance's rows (rasterize_pallas.py:1018-1083)
//     d mean2d = dgm (2 ca dx + cb dy, 2 cc dy + cb dx)  on the folded conic
//     d conic  = dgm (-dx^2 / 2, -dx dy, -dy^2 / 2)      in the true basis
//     d opacity = g dalpha  (summed directly, not K6's m0 / max(op, 1e-30))
//     d rgb  += alpha dN[0:3]                   (times z^2 once at the end)
//     d z    += 2z alpha K + z^2 alpha dN[3]    (the invz chain through the
//                                                depth weight and the feature)
//   The alpha clamp at 0.99 is straight-through (rasterize_jnp.py:233-236).
//   Unlike the sorted backward, a row depends only on its own instance and
//   its tile's pixels: there is no transmittance prefix to carry. So the
//   design is one block per tile and one thread per instance of the tile's
//   range (striding by 256 over longer ranges): the block stages the tile's
//   256 per-pixel cotangents (dN0..3, dD, rT; 6 KB) in shared memory once,
//   and each thread walks the 256 pixels in order, keeping its eleven sums
//   in registers. Each instance slot belongs to exactly one tile, so each
//   row is written once, coalesced, with no shuffles and no atomics; the
//   pixel order of every sum is fixed, so the plain twin sums in the same
//   order. (The K3' route, thread per pixel with warp-shuffle reductions,
//   would pay ten shuffle trees per instance and warp for rows that need
//   none.)
//   Bound on the card: operations, ~11 per evaluated pair and ~55 more per
//   kept pair, against 40 bytes per instance in and 40 out. Not done yet:
//   blocks of tiles with few instances leave most threads idle, and the
//   per-gaussian reduce (K4') is a separate pass.
//
// Every instance slot must lie in some tile's [start, end): the caller's
// per-frame buffer guarantees it, and K6' leaves any other slot unwritten.

#include "common.cuh"

namespace {

using gs::N_ATTR;
using gs::PPT;
using gs::TILE;

constexpr int N_COT = 6;  // staged per pixel: dN0..3, dD, rT

__global__ void __launch_bounds__(PPT) oit_fwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x,
    float* __restrict__ out)           // (T, 256, 8)
{
    __shared__ float batch[N_ATTR][PPT];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const float px = (float)((t % grid_x) * TILE + tid % TILE);
    const float py = (float)((t / grid_x) * TILE + tid / TILE);
    const int s = tile_start[t];
    const int e = tile_end[t];

    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, n3 = 0.0f, d = 0.0f, l = 0.0f;

    for (int b0 = s; b0 < e; b0 += PPT) {
        __syncthreads();  // the previous batch's readers are done
        const int nb = min(PPT, e - b0);
        if (tid < nb) {
#pragma unroll
            for (int r = 0; r < N_ATTR; ++r) batch[r][tid] = inst_t[r * k + b0 + tid];
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
            float dx, dy, power, g, alpha;
            if (!gs::pair_power(batch[0][j], batch[1][j], batch[2][j], batch[3][j],
                                batch[4][j], px, py, dx, dy, power)
                || !gs::pair_alpha(power, batch[5][j], g, alpha))
                continue;
            const float z = batch[9][j];
            const float aw = alpha * (z * z);
            n0 += aw * batch[6][j];
            n1 += aw * batch[7][j];
            n2 += aw * batch[8][j];
            n3 += aw * z;
            d += aw;
            l += log1pf(-alpha);
        }
    }

    float* o = out + ((long long)t * PPT + tid) * 8;
    o[0] = n0;
    o[1] = n1;
    o[2] = n2;
    o[3] = n3;
    o[4] = d;
    o[5] = expf(l);
    o[6] = 0.0f;
    o[7] = 0.0f;
}

__global__ void __launch_bounds__(PPT) oit_bwd_kernel(
    const float* __restrict__ inst_t,  // (16, K)
    long long k,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    int grid_x,
    const float* __restrict__ fwd,     // (T, 256, 8) forward output
    const float* __restrict__ dout,    // (T, 256, 8) its cotangent
    float* __restrict__ dinst)         // (10, K)
{
    __shared__ float cot[N_COT][PPT];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int s = tile_start[t];
    const int e = tile_end[t];
    if (s >= e) return;  // the whole block: an empty tile has no rows

    {
        const long long pix = (long long)t * PPT + tid;
        const float* d = dout + pix * 8;
#pragma unroll
        for (int c = 0; c < 5; ++c) cot[c][tid] = d[c];
        cot[5][tid] = d[5] * fwd[pix * 8 + 5];  // rT = dT * T_final
    }
    __syncthreads();

    const int tx = (t % grid_x) * TILE;
    const int ty = (t / grid_x) * TILE;

    for (long long i = s + tid; i < e; i += PPT) {
        const float mx = inst_t[0 * k + i], my = inst_t[1 * k + i];
        const float ca = inst_t[2 * k + i], cb = inst_t[3 * k + i], cc = inst_t[4 * k + i];
        const float op = inst_t[5 * k + i];
        const float r = inst_t[6 * k + i], gr = inst_t[7 * k + i], b = inst_t[8 * k + i];
        const float z = inst_t[9 * k + i];
        const float z2 = z * z;
        float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f, v5 = 0.0f;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, w = 0.0f;

        for (int p = 0; p < PPT; ++p) {
            const float px = (float)(tx + p % TILE);
            const float py = (float)(ty + p / TILE);
            float dx, dy, power, g, alpha;
            if (!gs::pair_power(mx, my, ca, cb, cc, px, py, dx, dy, power)
                || !gs::pair_alpha(power, op, g, alpha))
                continue;
            const float dn0 = cot[0][p], dn1 = cot[1][p], dn2 = cot[2][p], dn3 = cot[3][p];
            const float kk = (((dn0 * r + dn1 * gr) + dn2 * b) + dn3 * z) + cot[4][p];
            const float inv_one_m = 1.0f / (1.0f - alpha);
            const float dalpha = z2 * kk - cot[5][p] * inv_one_m;
            const float dgm = (op * dalpha) * g;
            v0 += dgm * ((ca + ca) * dx + cb * dy);
            v1 += dgm * ((cc + cc) * dy + cb * dx);
            v2 += -0.5f * (dgm * dx * dx);
            v3 += -(dgm * dx * dy);
            v4 += -0.5f * (dgm * dy * dy);
            v5 += g * dalpha;
            a0 += alpha * dn0;
            a1 += alpha * dn1;
            a2 += alpha * dn2;
            a3 += alpha * dn3;
            w += alpha * kk;
        }

        dinst[0 * k + i] = v0;
        dinst[1 * k + i] = v1;
        dinst[2 * k + i] = v2;
        dinst[3 * k + i] = v3;
        dinst[4 * k + i] = v4;
        dinst[5 * k + i] = v5;
        dinst[6 * k + i] = z2 * a0;
        dinst[7 * k + i] = z2 * a1;
        dinst[8 * k + i] = z2 * a2;
        dinst[9 * k + i] = (z + z) * w + z2 * a3;
    }
}

}  // namespace

extern "C" int gs_oit_fwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, void* out, void* stream)
{
    oit_fwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        grid_x, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int gs_oit_bwd(
    const void* inst_t, long long k, const void* tile_start, const void* tile_end,
    int num_tiles, int grid_x, const void* fwd, const void* dout, void* dinst,
    void* stream)
{
    oit_bwd_kernel<<<num_tiles, PPT, 0, (cudaStream_t)stream>>>(
        (const float*)inst_t, k, (const int*)tile_start, (const int*)tile_end,
        grid_x, (const float*)fwd, (const float*)dout, (float*)dinst);
    return (int)cudaGetLastError();
}
