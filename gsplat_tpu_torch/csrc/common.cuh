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

}  // namespace gs
