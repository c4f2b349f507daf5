// Device helpers shared by the port's kernels.
//
// `pair_power` and `pair_alpha` are the one place where a (pixel, instance)
// pair's power, alpha and keep decision are computed: the forward blend
// (K2', rasterize_fwd.cu) and the backward (K3', rasterize_bwd.cu) both call
// them,
// so the backward re-walks exactly the pairs the forward kept and stops
// where it stopped. Built with -fmad=false: the association order below is
// the JAX package's (`rasterize_pallas.py:204-206`), which FMA contraction
// would change.
//
// `pixel_box`, `reaches`, `warp_pixel` and `warp_rect` are the warp cull
// both blend kernels share (below): a warp skips an instance that cannot be
// kept at any of its pixels, which changes no output bit.
//
// `round_bf16` is the bf16 rounding of the hybrid packet mode (round to
// nearest even, `binning.py:747-784`, `reduce.py:216-230`), the same
// conversion that torch's `.to(torch.bfloat16)` does on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gs {

constexpr int TILE = 16;
constexpr int PPT = TILE * TILE;  // pixels per tile == threads per blend block
constexpr int N_ATTR = 10;        // table rows: mx, my, ca, cb, cc, op, r, g, b, invz
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

// One (pixel, instance) pair, in two steps so that the caller reads the
// opacity from shared memory only for pairs that pass the power test (a
// function taking the staged batch by reference compiled to slower generic
// loads in K2'). `pair_power` evaluates the folded conic [-a/2, -b, -c/2]
// at the pixel and returns the power test (power <= 0, false for NaN);
// `pair_alpha`, for a pair that passed, sets `g` = exp(power) and `alpha` =
// min(op * g, 0.99) (a clamp that propagates NaN, as torch.clamp does) and
// returns the keep decision alpha >= 1/255 (false for NaN). So a NaN conic
// or opacity drops the pair.
__device__ __forceinline__ bool pair_power(
    float mx, float my, float ca, float cb, float cc, float px, float py,
    float& dx, float& dy, float& power)
{
    dx = mx - px;
    dy = my - py;
    power = (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
    return power <= 0.0f;
}

__device__ __forceinline__ bool pair_alpha(float power, float op, float& g, float& alpha)
{
    g = expf(power);
    const float a = op * g;
    alpha = a > ALPHA_MAX ? ALPHA_MAX : a;
    return alpha >= ALPHA_MIN;
}

__device__ __forceinline__ float round_bf16(float x)
{
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The conservative warp cull of K2' and K3'.
//
// `pixel_box` bounds, in pixel coordinates, every pixel at which the keep
// test above can keep the instance: with tau = ln(255 op), a kept pair has
// -power <= tau, and for a positive-definite folded conic (a' = -ca,
// b' = -cb, c' = -cc) that bounds |dx| by sqrt(4 c' tau / (4 a'c' - b'^2))
// and |dy| by sqrt(4 a' tau / (4 a'c' - b'^2)). The box errs wide under
// float32 rounding with the binning's tight-cull margins
// (`ops/projection.py`): tau_m = tau + 1/32 + |tau|/128, and a radius of
// 1 + sqrt(r^2 + 4 + r^2/16). It is
//   the whole plane (+-inf) for any non-finite input, and for a conic that
//     is not positive definite or so close to degenerate (4a'c' - b'^2 <=
//     DEGENERATE * 4a'c') that the rounding of `power` could outgrow the
//     margin: no cull, the keep test decides;
//   empty (x0 = +inf, x1 = -inf) when op <= 0 or tau_m is below 0: no pair
//     can reach alpha >= 1/255 (at op = 1/255 exactly the margin keeps the
//     mean inside).
// `tau` is set to tau_m where the box is finite.
//
// `reaches` decides whether a warp walks an instance: the box must meet the
// warp's pixel rectangle R and, where the box is finite, the conic's
// minimum over R widened by 1/16 px must be at most tau_m (the minimum over
// a rectangle that does not hold the mean lies on one of its four edges,
// each a clamped 1D quadratic). Why that keeps every kept pair: past
// DEGENERATE the terms of `power` and of each edge value are within a
// factor of (1 + sqrt rho) / (1 - sqrt rho) < 4000 of the conic's value
// (rho = b'^2 / 4a'c'), so each rounds to within ~1e-3 of it, which the
// 1/128 relative margin of tau_m covers twice; the 1/16 px widening covers
// the rounding of the edges' offsets from the mean.
// Plain twins: `ops/rasterize_cuda.py:pixel_box_torch`, `warp_reaches_torch`,
// with the same arithmetic in the same order.
constexpr float DEGENERATE = 1e-3f;
constexpr float EDGE_PAD = 0.0625f;

__device__ __forceinline__ void pixel_box(
    float mx, float my, float ca, float cb, float cc, float op,
    float& x0, float& x1, float& y0, float& y1, float& tau)
{
    const float inf = __int_as_float(0x7f800000);
    x0 = -inf; x1 = inf; y0 = -inf; y1 = inf; tau = inf;
    if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc)
          && isfinite(op)))
        return;
    if (!(op > 0.0f)) {
        x0 = inf; x1 = -inf; y0 = inf; y1 = -inf; tau = -inf;
        return;
    }
    const float ln = logf(255.0f * op);
    const float tau_m = (ln + 0.03125f) + 0.0078125f * fabsf(ln);
    if (tau_m < 0.0f) {
        x0 = inf; x1 = -inf; y0 = inf; y1 = -inf; tau = -inf;
        return;
    }
    const float a = -ca, b = -cb, c = -cc;
    const float four_ac = 4.0f * a * c;
    const float det = four_ac - b * b;
    if (!(a > 0.0f && c > 0.0f && det > DEGENERATE * four_ac))
        return;
    const float rx2 = 4.0f * c * tau_m / det;
    const float ry2 = 4.0f * a * tau_m / det;
    const float rx = 1.0f + sqrtf((rx2 + 4.0f) + 0.0625f * fabsf(rx2));
    const float ry = 1.0f + sqrtf((ry2 + 4.0f) + 0.0625f * fabsf(ry2));
    x0 = mx - rx; x1 = mx + rx; y0 = my - ry; y1 = my + ry; tau = tau_m;
}

// min over v in [v0, v1] of p u^2 + q u v + r v^2 (r > 0)
__device__ __forceinline__ float edge_min(float u, float v0, float v1, float p, float q, float r)
{
    const float v = fminf(fmaxf(-(q * u) / (r + r), v0), v1);
    return (p * u * u + r * v * v) + q * u * v;
}

__device__ __forceinline__ bool reaches(
    float mx, float my, float ca, float cb, float cc, float tau,
    float x0, float x1, float y0, float y1, float wx0, float wx1, float wy0, float wy1)
{
    if (!(x0 <= wx1 && x1 >= wx0 && y0 <= wy1 && y1 >= wy0)) return false;
    if (isinf(x0)) return true;  // the whole plane: no conic test
    // dx = mx - px and dy = my - py over R widened by EDGE_PAD
    const float u0 = mx - (wx1 + EDGE_PAD), u1 = mx - (wx0 - EDGE_PAD);
    const float v0 = my - (wy1 + EDGE_PAD), v1 = my - (wy0 - EDGE_PAD);
    if (u0 <= 0.0f && u1 >= 0.0f && v0 <= 0.0f && v1 >= 0.0f) return true;
    const float a = -ca, b = -cb, c = -cc;
    const float q = fminf(fminf(edge_min(u0, v0, v1, a, b, c), edge_min(u1, v0, v1, a, b, c)),
                          fminf(edge_min(v0, u0, u1, c, b, a), edge_min(v1, u0, u1, c, b, a)));
    return q <= tau;
}

// Which pixels a warp owns: a WARP_W x WARP_H block of the tile (8 x 4:
// eight blocks in two columns of four). `warp_pixel` is the pixel index
// (row-major in the tile) of a lane, `warp_rect` the warp's pixel
// rectangle [wx0, wx1] x [wy0, wy1], both ends inclusive.
constexpr int WARP_W = 8;
constexpr int WARP_H = 4;

__device__ __forceinline__ int warp_pixel(int warp, int lane)
{
    const int lx = (warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W;
    const int ly = (warp / (TILE / WARP_W)) * WARP_H + lane / WARP_W;
    return ly * TILE + lx;
}

__device__ __forceinline__ void warp_rect(
    int warp, int tx0, int ty0, float& wx0, float& wx1, float& wy0, float& wy1)
{
    wx0 = (float)(tx0 + (warp % (TILE / WARP_W)) * WARP_W);
    wy0 = (float)(ty0 + (warp / (TILE / WARP_W)) * WARP_H);
    wx1 = wx0 + (float)(WARP_W - 1);
    wy1 = wy0 + (float)(WARP_H - 1);
}

}  // namespace gs
