// Projection and SH colour, forward and backward, on Hopper (sm_90a).
//
// Counterpart of the JAX package's `preprocess` (gsplat_tpu/ops/projection.py
// :120-310), which has no Pallas kernel: XLA compiles it under `jit` into a
// few fusions. Eager PyTorch ran it as ~150 elementwise launches forward and
// as many in autograd's backward, over every row of the model (half of them
// dead on a train frame). Here it is one kernel in each direction, as the
// CUDA rasterizer does it (`preprocessCUDA`/`computeColorFromSH` forward,
// `computeCov2DCUDA`/`preprocessCUDA` backward).
//
// `gs_project_fwd`: one thread per row. A live row (`alive`) reads its
// parameters once (xyz, log-scales, quaternion, logit opacity, and only the
// (d+1)^2 SH coefficients of the active degree, in place: no concatenation
// of features_dc and features_rest) and writes every ScreenGaussians field.
// A dead row reads nothing but its `alive` byte and writes zeros (mask
// false). The operation order is the plain twin's (`preprocess_torch`,
// ops/projection.py), which keeps the JAX package's: EWA with the clamped
// Jacobian, the +0.3 dilation and antialiasing, `radius_f`, the truncating
// rect casts, the tight-cull rect and `cull_qmax`. Built with -fmad=false
// and without fast math, every operation rounds as torch's CUDA kernels do
// (IEEE `/` and `sqrtf`, the same `expf`, `logf` and `ceilf`), so the
// outputs equal the twin's bit for bit on the card: the integer outputs feed
// K1', which is held bit for bit. Constants are the twin's Python doubles
// rounded to float (`F`), as torch rounds a Python scalar. Three details of
// torch's rounding are kept on purpose: `width / (2 tan)` is torch's
// `reciprocal() * width`; `x / tile` with a Python scalar is `x * (1/tile)`;
// `torch.clamp` and `torch.minimum` propagate NaN.
//
// `gs_project_bwd`: one thread per row, no atomics. It recomputes the
// forward's intermediates from the parameters (`geometry`, shared with the
// forward) rather than saving them, reads the five cotangents where they lie
// through their strides (the blend's are strided (N, k) views of K4''s
// (N, 16) accumulator) and writes the seven gradients: xyz, scaling,
// rotation, opacity, features_dc, features_rest (zero above the active
// degree) and mean2d_offset. A block stages its rows' gradients in shared
// memory (`Stage`, 31 KB at degree 3) and writes each output as one
// contiguous run: stored from registers, a warp's store of one component
// touched 32 rows 12-180 B apart, and a version that did so ran at 7.3
// times its byte bound on the train frame (`PERF.md`). It is the explicit VJP `preprocess_bwd_torch`,
// statement for statement. Dead rows get zeros and their parameters are
// never read; culled rows follow the forward's `torch.where` sanitising.
//
// Templated on the SH degree (0-4; the JAX package evaluates degree 4,
// gsplat_tpu/core/sh.py:89), on antialiasing and, forward only, on the
// tight cull.
//
// Bound on the card: bytes. Per live row the forward reads 40 B of geometry
// and 12 (d+1)^2 B of SH and writes 69 B; the backward reads those
// parameters and 40 B of cotangents and writes 244 B of gradients (degree
// 3). A few hundred float operations per row are far below the FP32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct ProjectParams {
    const float* xyz;            // (N, 3)
    const float* scaling;        // (N, 3) log-scales
    const float* rotation;       // (N, 4) wxyz, unnormalised
    const float* opacity;        // (N, 1) logits
    const float* features_dc;    // (N, 1, 3)
    const float* features_rest;  // (N, k_rest, 3)
    const float* mean2d_offset;  // (N, 2) or NULL
    const bool* alive;           // (N,)
    const float* world_view;     // (4, 4) row-major
    const float* full_proj;      // (4, 4) row-major
    const float* camera_center;  // (3,)
    const float* tan_fovx;       // ()
    const float* tan_fovy;       // ()
    long long n;
    int k_rest, width, height, grid_x, grid_y, tile;
    float scale_modifier;
};

struct ProjectOutputs {
    float* mean2d; float* conic; float* opacity; float* rgb; float* depth;
    int* radius; float* cull_qmax; int* rect_min; int* rect_max; int* tiles_touched;
    bool* mask;
};

// each cotangent (NULL: zero) with its strides in elements: row, column
struct ProjectCotangents {
    const float* mean2d; long long mean2d_s0, mean2d_s1;
    const float* conic; long long conic_s0, conic_s1;
    const float* opacity; long long opacity_s0, opacity_s1;
    const float* rgb; long long rgb_s0, rgb_s1;
    const float* depth; long long depth_s0, depth_s1;
};

struct ProjectGrads {
    float* xyz; float* scaling; float* rotation; float* opacity;
    float* features_dc; float* features_rest; float* mean2d_offset;  // last may be NULL
};

namespace {

#define F(x) static_cast<float>(x)

constexpr int BLOCK = 128;

// the SH constants of core/sh.py, as Python doubles (scalars: a constexpr
// array is host-only in device code)
constexpr double SH_C0 = 0.28209479177387814;
constexpr double SH_C1 = 0.4886025119029199;
constexpr double SH_C2_0 = 1.0925484305920792;
constexpr double SH_C2_1 = -1.0925484305920792;
constexpr double SH_C2_2 = 0.31539156525252005;
constexpr double SH_C2_3 = -1.0925484305920792;
constexpr double SH_C2_4 = 0.5462742152960396;
constexpr double SH_C3_0 = -0.5900435899266435;
constexpr double SH_C3_1 = 2.890611442640554;
constexpr double SH_C3_2 = -0.4570457994644658;
constexpr double SH_C3_3 = 0.3731763325901154;
constexpr double SH_C3_4 = -0.4570457994644658;
constexpr double SH_C3_5 = 1.445305721320277;
constexpr double SH_C3_6 = -0.5900435899266435;
constexpr double SH_C4_0 = 2.5033429417967046;
constexpr double SH_C4_1 = -1.7701307697799304;
constexpr double SH_C4_2 = 0.9461746957575601;
constexpr double SH_C4_3 = -0.6690465435572892;
constexpr double SH_C4_4 = 0.10578554691520431;
constexpr double SH_C4_5 = -0.6690465435572892;
constexpr double SH_C4_6 = 0.47308734787878004;
constexpr double SH_C4_7 = -1.7701307697799304;
constexpr double SH_C4_8 = 0.6258357354491761;

// torch.clamp / torch.minimum on the card: NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_to(float v, float lo, float hi)
{
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float nan_minimum(float a, float b)
{
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the camera, staged once per block
struct Cam {
    float w[16], p[16], cc[3];
    float fx, fy, limx, limy;
};

__device__ __forceinline__ void load_camera(const ProjectParams& a, Cam& cam)
{
    const int t = threadIdx.x;
    if (t < 16) {
        cam.w[t] = a.world_view[t];
        cam.p[t] = a.full_proj[t];
    }
    if (t < 3) cam.cc[t] = a.camera_center[t];
    if (t == 0) {
        const float tx = *a.tan_fovx, ty = *a.tan_fovy;
        cam.fx = (1.0f / (2.0f * tx)) * F(a.width);  // Camera.focal_x
        cam.fy = (1.0f / (2.0f * ty)) * F(a.height);
        cam.limx = F(1.3) * tx;
        cam.limy = F(1.3) * ty;
    }
    __syncthreads();
}

// The forward's intermediates of one live row (preprocess_torch up to the
// conic; both kernels call this, so the backward recomputes exactly what
// the forward computed).
struct Geo {
    float s[3], S[3], v[3];
    float qa[4], n0, qq[4], n1;
    float R[3][3];
    float c[6];
    float op;
    float pvx, pvy, pvz;
    bool v0;
    float ph0, ph1, wh, pw;
    float tz, rxr, ryr, txtz, tytz, txp, typ, itz, itz2;
    float t0[3], t1[3], u[3], w[3];
    float cxx, cxy, cyy, d0, d1, d2, det, det_inv;
    float ratio, h;
};

template <bool AA>
__device__ __forceinline__ void geometry(const ProjectParams& a, const Cam& cam, long long i,
                                         float x, float y, float z, Geo& g)
{
    for (int k = 0; k < 3; ++k) g.s[k] = expf(a.scaling[3 * i + k]);
    float q[4];
    for (int k = 0; k < 4; ++k) q[k] = a.rotation[4 * i + k];
    // normalize_rotation, then again inside covariance_from_scaling_rotation
    g.n0 = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3] + 0.0f);
    for (int k = 0; k < 4; ++k) g.qa[k] = q[k] / g.n0;
    g.n1 = sqrtf(((g.qa[0] * g.qa[0] + g.qa[1] * g.qa[1]) + g.qa[2] * g.qa[2])
                 + g.qa[3] * g.qa[3] + 0.0f);
    for (int k = 0; k < 4; ++k) g.qq[k] = g.qa[k] / g.n1;
    const float r = g.qq[0], qx = g.qq[1], qy = g.qq[2], qz = g.qq[3];
    g.op = 1.0f / (1.0f + expf(-a.opacity[i]));  // torch.sigmoid

    g.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
    g.R[0][1] = 2.0f * (qx * qy - r * qz);
    g.R[0][2] = 2.0f * (qx * qz + r * qy);
    g.R[1][0] = 2.0f * (qx * qy + r * qz);
    g.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
    g.R[1][2] = 2.0f * (qy * qz - r * qx);
    g.R[2][0] = 2.0f * (qx * qz - r * qy);
    g.R[2][1] = 2.0f * (qy * qz + r * qx);
    g.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
    for (int k = 0; k < 3; ++k) {
        g.S[k] = g.s[k] * a.scale_modifier;
        g.v[k] = g.S[k] * g.S[k];
    }
    const int A[6] = {0, 0, 0, 1, 1, 2}, B[6] = {0, 1, 2, 1, 2, 2};
    for (int e = 0; e < 6; ++e) {
        const float* ra = g.R[A[e]];
        const float* rb = g.R[B[e]];
        g.c[e] = (g.v[0] * ra[0] * rb[0] + g.v[1] * ra[1] * rb[1]) + g.v[2] * ra[2] * rb[2];
    }

    const float* W = cam.w;
    const float* P = cam.p;
    g.pvx = W[0] * x + W[1] * y + W[2] * z + W[3];
    g.pvy = W[4] * x + W[5] * y + W[6] * z + W[7];
    g.pvz = W[8] * x + W[9] * y + W[10] * z + W[11];
    g.v0 = g.pvz > F(0.2);
    g.ph0 = P[0] * x + P[1] * y + P[2] * z + P[3];
    g.ph1 = P[4] * x + P[5] * y + P[6] * z + P[7];
    g.wh = P[12] * x + P[13] * y + P[14] * z + P[15];
    g.pw = 1.0f / ((g.v0 ? g.wh : 1.0f) + F(1e-7));

    // compute_cov2d on the sanitised view point
    g.tz = g.v0 ? g.pvz : 1.0f;
    g.rxr = g.pvx / g.tz;
    g.ryr = g.pvy / g.tz;
    g.txtz = clamp_to(g.rxr, -cam.limx, cam.limx);
    g.tytz = clamp_to(g.ryr, -cam.limy, cam.limy);
    g.txp = g.txtz * g.tz;
    g.typ = g.tytz * g.tz;
    g.itz = 1.0f / g.tz;
    g.itz2 = g.itz * g.itz;
    const float j00 = cam.fx * g.itz, j02 = -cam.fx * g.txp * g.itz2;
    const float j11 = cam.fy * g.itz, j12 = -cam.fy * g.typ * g.itz2;
    for (int k = 0; k < 3; ++k) {
        g.t0[k] = j00 * W[k] + j02 * W[8 + k];
        g.t1[k] = j11 * W[4 + k] + j12 * W[8 + k];
    }
    const float* c = g.c;
    g.u[0] = c[0] * g.t0[0] + c[1] * g.t0[1] + c[2] * g.t0[2];
    g.u[1] = c[1] * g.t0[0] + c[3] * g.t0[1] + c[4] * g.t0[2];
    g.u[2] = c[2] * g.t0[0] + c[4] * g.t0[1] + c[5] * g.t0[2];
    g.w[0] = c[0] * g.t1[0] + c[1] * g.t1[1] + c[2] * g.t1[2];
    g.w[1] = c[1] * g.t1[0] + c[3] * g.t1[1] + c[4] * g.t1[2];
    g.w[2] = c[2] * g.t1[0] + c[4] * g.t1[1] + c[5] * g.t1[2];
    g.cxx = g.v0 ? g.t0[0] * g.u[0] + g.t0[1] * g.u[1] + g.t0[2] * g.u[2] : 1.0f;
    g.cxy = g.v0 ? g.t1[0] * g.u[0] + g.t1[1] * g.u[1] + g.t1[2] * g.u[2] : 0.0f;
    g.cyy = g.v0 ? g.t1[0] * g.w[0] + g.t1[1] * g.w[1] + g.t1[2] * g.w[2] : 1.0f;
    g.d0 = g.cxx + F(0.3);
    g.d1 = g.cxy;
    g.d2 = g.cyy + F(0.3);
    g.det = g.d0 * g.d2 - g.d1 * g.d1;
    if (AA) {
        const float det_cov = g.cxx * g.cyy - g.cxy * g.cxy;
        g.ratio = det_cov / g.det;
        g.h = sqrtf(clamp_min(g.ratio, F(2.5e-5)));
    } else {
        g.h = 1.0f;
    }
    g.det_inv = 1.0f / (g.det == 0.0f ? 1.0f : g.det);
}

// the unit view direction and the real SH basis of sh_lib.sh_basis
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b)
{
    b[0] = F(SH_C0);
    if (DEG >= 1) {
        b[1] = F(-SH_C1) * y;
        b[2] = F(SH_C1) * z;
        b[3] = F(-SH_C1) * x;
    }
    if (DEG >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        b[4] = F(SH_C2_0) * xy;
        b[5] = F(SH_C2_1) * yz;
        b[6] = F(SH_C2_2) * (2.0f * zz - xx - yy);
        b[7] = F(SH_C2_3) * xz;
        b[8] = F(SH_C2_4) * (xx - yy);
        if (DEG >= 3) {
            b[9] = F(SH_C3_0) * y * (3.0f * xx - yy);
            b[10] = F(SH_C3_1) * xy * z;
            b[11] = F(SH_C3_2) * y * (4.0f * zz - xx - yy);
            b[12] = F(SH_C3_3) * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
            b[13] = F(SH_C3_4) * x * (4.0f * zz - xx - yy);
            b[14] = F(SH_C3_5) * z * (xx - yy);
            b[15] = F(SH_C3_6) * x * (xx - 3.0f * yy);
        }
        if (DEG >= 4) {
            b[16] = F(SH_C4_0) * xy * (xx - yy);
            b[17] = F(SH_C4_1) * yz * (3.0f * xx - yy);
            b[18] = F(SH_C4_2) * xy * (7.0f * zz - 1.0f);
            b[19] = F(SH_C4_3) * yz * (7.0f * zz - 3.0f);
            b[20] = F(SH_C4_4) * (zz * (35.0f * zz - 30.0f) + 3.0f);
            b[21] = F(SH_C4_5) * xz * (7.0f * zz - 3.0f);
            b[22] = F(SH_C4_6) * (xx - yy) * (7.0f * zz - 1.0f);
            b[23] = F(SH_C4_7) * xz * (xx - 3.0f * yy);
            b[24] = F(SH_C4_8) * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
        }
    }
}

// the SH coefficient j (0..K-1) of row i, channel ch, read in place
__device__ __forceinline__ float coeff(const ProjectParams& a, long long i, int j, int ch)
{
    return j == 0 ? a.features_dc[3 * i + ch]
                  : a.features_rest[(i * a.k_rest + (j - 1)) * 3 + ch];
}

// d colour / d unit direction (preprocess_bwd_torch's _sh_dir_grad): the
// cotangent db[k] of basis function k times its partials, summed in
// ascending k
template <int DEG>
__device__ __forceinline__ void sh_dir_grad(float x, float y, float z, const float* db,
                                            float& gx, float& gy, float& gz)
{
    gx = 0.0f;
    gy = 0.0f;
    gz = 0.0f;
    if (DEG >= 1) {
        gy = gy + db[1] * F(-SH_C1);
        gz = gz + db[2] * F(SH_C1);
        gx = gx + db[3] * F(-SH_C1);
    }
    if (DEG >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        gx = gx + db[4] * (F(SH_C2_0) * y);
        gy = gy + db[4] * (F(SH_C2_0) * x);
        gy = gy + db[5] * (F(SH_C2_1) * z);
        gz = gz + db[5] * (F(SH_C2_1) * y);
        gx = gx + db[6] * (F(SH_C2_2) * (-2.0f * x));
        gy = gy + db[6] * (F(SH_C2_2) * (-2.0f * y));
        gz = gz + db[6] * (F(SH_C2_2) * (4.0f * z));
        gx = gx + db[7] * (F(SH_C2_3) * z);
        gz = gz + db[7] * (F(SH_C2_3) * x);
        gx = gx + db[8] * (F(SH_C2_4) * (2.0f * x));
        gy = gy + db[8] * (F(SH_C2_4) * (-2.0f * y));
        if (DEG >= 3) {
            gx = gx + db[9] * (F(SH_C3_0) * (6.0f * xy));
            gy = gy + db[9] * (F(SH_C3_0) * (3.0f * xx - 3.0f * yy));
            gx = gx + db[10] * (F(SH_C3_1) * yz);
            gy = gy + db[10] * (F(SH_C3_1) * xz);
            gz = gz + db[10] * (F(SH_C3_1) * xy);
            gx = gx + db[11] * (F(SH_C3_2) * (-2.0f * xy));
            gy = gy + db[11] * (F(SH_C3_2) * (4.0f * zz - xx - 3.0f * yy));
            gz = gz + db[11] * (F(SH_C3_2) * (8.0f * yz));
            gx = gx + db[12] * (F(SH_C3_3) * (-6.0f * xz));
            gy = gy + db[12] * (F(SH_C3_3) * (-6.0f * yz));
            gz = gz + db[12] * (F(SH_C3_3) * (6.0f * zz - 3.0f * xx - 3.0f * yy));
            gx = gx + db[13] * (F(SH_C3_4) * (4.0f * zz - 3.0f * xx - yy));
            gy = gy + db[13] * (F(SH_C3_4) * (-2.0f * xy));
            gz = gz + db[13] * (F(SH_C3_4) * (8.0f * xz));
            gx = gx + db[14] * (F(SH_C3_5) * (2.0f * xz));
            gy = gy + db[14] * (F(SH_C3_5) * (-2.0f * yz));
            gz = gz + db[14] * (F(SH_C3_5) * (xx - yy));
            gx = gx + db[15] * (F(SH_C3_6) * (3.0f * xx - 3.0f * yy));
            gy = gy + db[15] * (F(SH_C3_6) * (-6.0f * xy));
        }
        if (DEG >= 4) {
            gx = gx + db[16] * (F(SH_C4_0) * (y * (3.0f * xx - yy)));
            gy = gy + db[16] * (F(SH_C4_0) * (x * (xx - 3.0f * yy)));
            gx = gx + db[17] * (F(SH_C4_1) * ((6.0f * xy) * z));
            gy = gy + db[17] * (F(SH_C4_1) * (z * (3.0f * xx - 3.0f * yy)));
            gz = gz + db[17] * (F(SH_C4_1) * (y * (3.0f * xx - yy)));
            gx = gx + db[18] * (F(SH_C4_2) * (y * (7.0f * zz - 1.0f)));
            gy = gy + db[18] * (F(SH_C4_2) * (x * (7.0f * zz - 1.0f)));
            gz = gz + db[18] * (F(SH_C4_2) * ((14.0f * xy) * z));
            gy = gy + db[19] * (F(SH_C4_3) * (z * (7.0f * zz - 3.0f)));
            gz = gz + db[19] * (F(SH_C4_3) * (y * (21.0f * zz - 3.0f)));
            gz = gz + db[20] * (F(SH_C4_4) * (z * (140.0f * zz - 60.0f)));
            gx = gx + db[21] * (F(SH_C4_5) * (z * (7.0f * zz - 3.0f)));
            gz = gz + db[21] * (F(SH_C4_5) * (x * (21.0f * zz - 3.0f)));
            gx = gx + db[22] * (F(SH_C4_6) * ((2.0f * x) * (7.0f * zz - 1.0f)));
            gy = gy + db[22] * (F(SH_C4_6) * ((-2.0f * y) * (7.0f * zz - 1.0f)));
            gz = gz + db[22] * (F(SH_C4_6) * ((xx - yy) * (14.0f * z)));
            gx = gx + db[23] * (F(SH_C4_7) * (z * (3.0f * xx - 3.0f * yy)));
            gy = gy + db[23] * (F(SH_C4_7) * ((-6.0f * xy) * z));
            gz = gz + db[23] * (F(SH_C4_7) * (x * (xx - 3.0f * yy)));
            gx = gx + db[24] * (F(SH_C4_8) * ((4.0f * x) * (xx - 3.0f * yy)));
            gy = gy + db[24] * (F(SH_C4_8) * ((4.0f * y) * (yy - 3.0f * xx)));
        }
    }
}

// the rect of getRect (auxiliary.h:45-55): truncating casts, then clamp
__device__ __forceinline__ void rect_of(float px, float py, float rx, float ry, float tile,
                                        float inv_tile, int gx, int gy, int r[4])
{
    r[0] = clamp_int((int)((px - rx) * inv_tile), 0, gx);
    r[1] = clamp_int((int)((py - ry) * inv_tile), 0, gy);
    r[2] = clamp_int((int)((px + rx + tile - 1.0f) * inv_tile), 0, gx);
    r[3] = clamp_int((int)((py + ry + tile - 1.0f) * inv_tile), 0, gy);
}

template <int DEG, bool AA, bool TIGHT>
__global__ void __launch_bounds__(BLOCK) project_fwd_kernel(ProjectParams a, ProjectOutputs o)
{
    __shared__ Cam cam;
    load_camera(a, cam);
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= a.n) return;
    if (!a.alive[i]) {
        o.mean2d[2 * i] = 0.0f;
        o.mean2d[2 * i + 1] = 0.0f;
        for (int k = 0; k < 3; ++k) {
            o.conic[3 * i + k] = 0.0f;
            o.rgb[3 * i + k] = 0.0f;
        }
        o.opacity[i] = 0.0f;
        o.depth[i] = 0.0f;
        o.radius[i] = 0;
        o.cull_qmax[i] = 0.0f;
        for (int k = 0; k < 2; ++k) {
            o.rect_min[2 * i + k] = 0;
            o.rect_max[2 * i + k] = 0;
        }
        o.tiles_touched[i] = 0;
        o.mask[i] = false;
        return;
    }
    const float x = a.xyz[3 * i], y = a.xyz[3 * i + 1], z = a.xyz[3 * i + 2];
    Geo g;
    geometry<AA>(a, cam, i, x, y, z, g);

    bool valid = g.v0 && g.det != 0.0f;
    o.conic[3 * i] = g.d2 * g.det_inv;
    o.conic[3 * i + 1] = -g.d1 * g.det_inv;
    o.conic[3 * i + 2] = g.d0 * g.det_inv;
    const float mid = 0.5f * (g.d0 + g.d2);
    const float lam_term = sqrtf(clamp_min(mid * mid - g.det, F(0.1)));
    const float lambda1 = mid + lam_term;
    const float radius_f = ceilf(3.0f * sqrtf(clamp_min(lambda1, F(1e-20))));

    float px = ((g.ph0 * g.pw + 1.0f) * F(a.width) - 1.0f) * 0.5f;
    float py = ((g.ph1 * g.pw + 1.0f) * F(a.height) - 1.0f) * 0.5f;
    if (a.mean2d_offset != nullptr) {
        px = px + a.mean2d_offset[2 * i];
        py = py + a.mean2d_offset[2 * i + 1];
    }
    const float op_eff = g.op * g.h;
    const float ln_term = logf(clamp_min(op_eff * 255.0f, F(1e-12)));

    const float tile = F(a.tile), inv_tile = 1.0f / F(a.tile);
    int ref[4], rect[4];
    rect_of(px, py, radius_f, radius_f, tile, inv_tile, a.grid_x, a.grid_y, ref);
    const int tiles_ref = (ref[2] - ref[0]) * (ref[3] - ref[1]);
    valid = valid && tiles_ref > 0;
    int tiles;
    if (TIGHT) {
        const bool vis = op_eff * 255.0f >= F(0.999999);
        const float rx2 = 2.0f * g.d0 * ln_term;
        const float ry2 = 2.0f * g.d2 * ln_term;
        const float rx = nan_minimum(
            radius_f, 1.0f + sqrtf(clamp_min(rx2 + 4.0f + 0.0625f * fabsf(rx2), 0.0f)));
        const float ry = nan_minimum(
            radius_f, 1.0f + sqrtf(clamp_min(ry2 + 4.0f + 0.0625f * fabsf(ry2), 0.0f)));
        rect_of(px, py, rx, ry, tile, inv_tile, a.grid_x, a.grid_y, rect);
        tiles = valid && vis ? (rect[2] - rect[0]) * (rect[3] - rect[1]) : 0;
    } else {
        for (int k = 0; k < 4; ++k) rect[k] = ref[k];
        tiles = valid ? tiles_ref : 0;
    }

    // SH -> RGB (eval_sh_color), coefficients of the active degree only
    constexpr int K = (DEG + 1) * (DEG + 1);
    const float dxr = x - cam.cc[0], dyr = y - cam.cc[1], dzr = z - cam.cc[2];
    const float dlen = sqrtf((dxr * dxr + dyr * dyr) + dzr * dzr);
    float b[K];
    sh_basis<DEG>(dxr / dlen, dyr / dlen, dzr / dlen, b);
    for (int ch = 0; ch < 3; ++ch) {
        float color = b[0] * coeff(a, i, 0, ch);
#pragma unroll
        for (int j = 1; j < K; ++j) color = color + b[j] * coeff(a, i, j, ch);
        o.rgb[3 * i + ch] = clamp_min(color + 0.5f, 0.0f);
    }

    o.mean2d[2 * i] = px;
    o.mean2d[2 * i + 1] = py;
    o.opacity[i] = op_eff;
    o.depth[i] = g.pvz;
    o.radius[i] = valid ? (int)radius_f : 0;
    o.cull_qmax[i] = ln_term + 0.03125f + 0.0078125f * fabsf(ln_term);
    o.rect_min[2 * i] = rect[0];
    o.rect_min[2 * i + 1] = rect[1];
    o.rect_max[2 * i] = rect[2];
    o.rect_max[2 * i + 1] = rect[3];
    o.tiles_touched[i] = tiles;
    o.mask[i] = valid;
}

__device__ __forceinline__ float cot_at(const float* p, long long off)
{
    return p == nullptr ? 0.0f : p[off];
}

// A block's gradients, staged in shared memory so that each of the seven
// outputs leaves as one contiguous run of the block's rows (a thread's row
// of features_rest alone spans 180 B at degree 3: stored from registers, a
// warp's store would touch 32 rows).
struct Stage {
    float *xyz, *scaling, *rotation, *opacity, *dc, *offset, *rest;
    int k3;  // floats of features_rest per row

    static constexpr int FIXED = 16;  // floats per row besides features_rest

    __device__ Stage(float* base, int k_rest) : k3(3 * k_rest)
    {
        xyz = base;
        scaling = xyz + 3 * BLOCK;
        rotation = scaling + 3 * BLOCK;
        opacity = rotation + 4 * BLOCK;
        dc = opacity + BLOCK;
        offset = dc + 3 * BLOCK;
        rest = offset + 2 * BLOCK;
    }

    __device__ void zero_row(int t)
    {
        for (int k = 0; k < 3; ++k) xyz[3 * t + k] = scaling[3 * t + k] = dc[3 * t + k] = 0.0f;
        for (int k = 0; k < 4; ++k) rotation[4 * t + k] = 0.0f;
        opacity[t] = offset[2 * t] = offset[2 * t + 1] = 0.0f;
        for (int k = 0; k < k3; ++k) rest[k3 * t + k] = 0.0f;
    }

    // after a barrier: the block's `rows` rows from row `first` on
    __device__ void store(const ProjectGrads& g, long long first, int rows) const
    {
        copy_out(g.xyz + 3 * first, xyz, 3 * rows);
        copy_out(g.scaling + 3 * first, scaling, 3 * rows);
        copy_out(g.rotation + 4 * first, rotation, 4 * rows);
        copy_out(g.opacity + first, opacity, rows);
        copy_out(g.features_dc + 3 * first, dc, 3 * rows);
        if (g.mean2d_offset != nullptr) copy_out(g.mean2d_offset + 2 * first, offset, 2 * rows);
        copy_out(g.features_rest + k3 * first, rest, k3 * rows);
    }

    __device__ static void copy_out(float* dst, const float* src, int count)
    {
        for (int j = threadIdx.x; j < count; j += BLOCK) dst[j] = src[j];
    }
};

// one live row's gradients (preprocess_bwd_torch), into row t of the stage
template <int DEG, bool AA>
__device__ __forceinline__ void bwd_row(const ProjectParams& a, const Cam& cam,
                                        const ProjectCotangents& ct, long long i, int t,
                                        Stage& out)
{
    const int k_rest = a.k_rest;
    const float gmx = cot_at(ct.mean2d, i * ct.mean2d_s0);
    const float gmy = cot_at(ct.mean2d, i * ct.mean2d_s0 + ct.mean2d_s1);
    const float gca = cot_at(ct.conic, i * ct.conic_s0);
    const float gcb = cot_at(ct.conic, i * ct.conic_s0 + ct.conic_s1);
    const float gcc = cot_at(ct.conic, i * ct.conic_s0 + 2 * ct.conic_s1);
    const float gop = cot_at(ct.opacity, i * ct.opacity_s0);
    float grgb[3];
    for (int ch = 0; ch < 3; ++ch) grgb[ch] = cot_at(ct.rgb, i * ct.rgb_s0 + ch * ct.rgb_s1);
    const float gdep = cot_at(ct.depth, i * ct.depth_s0);

    const float x = a.xyz[3 * i], y = a.xyz[3 * i + 1], z = a.xyz[3 * i + 2];
    Geo g;
    geometry<AA>(a, cam, i, x, y, z, g);
    const float* W = cam.w;
    const float* P = cam.p;

    // opacity: sigmoid, then the antialiasing scale
    const float dop = AA ? gop * g.h : gop;
    out.opacity[t] = dop * (1.0f - g.op) * g.op;

    // conic = [d2, -d1, d0] / det
    const float dd0 = gcc * g.det_inv;
    const float dd1 = -(gcb * g.det_inv);
    const float dd2 = gca * g.det_inv;
    const float ddinv = (gca * g.d2 - gcb * g.d1) + gcc * g.d0;
    float ddet = g.det != 0.0f ? -(ddinv * (g.det_inv * g.det_inv)) : 0.0f;
    float ddc = 0.0f;
    if (AA) {
        const float dratio = g.ratio >= F(2.5e-5) ? (gop * g.op) / (2.0f * g.h) : 0.0f;
        ddc = dratio / g.det;
        ddet = ddet - dratio * (g.ratio / g.det);
    }
    float dcxx = dd0 + ddet * g.d2;
    float dcyy = dd2 + ddet * g.d0;
    float dcxy = dd1 - 2.0f * (ddet * g.d1);
    if (AA) {
        dcxx = dcxx + ddc * g.cyy;
        dcyy = dcyy + ddc * g.cxx;
        dcxy = dcxy - 2.0f * (ddc * g.cxy);
    }
    dcxx = g.v0 ? dcxx : 0.0f;
    dcxy = g.v0 ? dcxy : 0.0f;
    dcyy = g.v0 ? dcyy : 0.0f;

    // cov2d = T Sigma T^T, T = J W
    const float* c = g.c;
    float du[3], dw[3], dt0[3], dt1[3];
    for (int k = 0; k < 3; ++k) {
        du[k] = dcxx * g.t0[k] + dcxy * g.t1[k];
        dw[k] = dcyy * g.t1[k];
    }
    const int ROW[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    for (int k = 0; k < 3; ++k) {
        const int* rw = ROW[k];
        dt0[k] = dcxx * g.u[k] + (du[0] * c[rw[0]] + du[1] * c[rw[1]] + du[2] * c[rw[2]]);
        dt1[k] = (dcxy * g.u[k] + dcyy * g.w[k])
                 + (dw[0] * c[rw[0]] + dw[1] * c[rw[1]] + dw[2] * c[rw[2]]);
    }
    float dc[6];
    dc[0] = du[0] * g.t0[0] + dw[0] * g.t1[0];
    dc[1] = ((du[0] * g.t0[1] + du[1] * g.t0[0]) + dw[0] * g.t1[1]) + dw[1] * g.t1[0];
    dc[2] = ((du[0] * g.t0[2] + du[2] * g.t0[0]) + dw[0] * g.t1[2]) + dw[2] * g.t1[0];
    dc[3] = du[1] * g.t0[1] + dw[1] * g.t1[1];
    dc[4] = ((du[1] * g.t0[2] + du[2] * g.t0[1]) + dw[1] * g.t1[2]) + dw[2] * g.t1[1];
    dc[5] = du[2] * g.t0[2] + dw[2] * g.t1[2];
    const float dj00 = (dt0[0] * W[0] + dt0[1] * W[1]) + dt0[2] * W[2];
    const float dj02 = (dt0[0] * W[8] + dt0[1] * W[9]) + dt0[2] * W[10];
    const float dj11 = (dt1[0] * W[4] + dt1[1] * W[5]) + dt1[2] * W[6];
    const float dj12 = (dt1[0] * W[8] + dt1[1] * W[9]) + dt1[2] * W[10];
    const float nfx = -cam.fx, nfy = -cam.fy;
    const float dtxp = dj02 * g.itz2 * nfx;
    const float dtyp = dj12 * g.itz2 * nfy;
    const float ditz2 = dj02 * (nfx * g.txp) + dj12 * (nfy * g.typ);
    const float ditz = (dj00 * cam.fx + dj11 * cam.fy) + (g.itz + g.itz) * ditz2;
    const bool in_x = g.rxr >= -cam.limx && g.rxr <= cam.limx;
    const bool in_y = g.ryr >= -cam.limy && g.ryr <= cam.limy;
    const float drx = in_x ? dtxp * g.tz : 0.0f;
    const float dry = in_y ? dtyp * g.tz : 0.0f;
    float dtz = (-(ditz * (g.itz * g.itz)) + dtxp * g.txtz) + dtyp * g.tytz;
    dtz = (dtz - drx * (g.rxr / g.tz)) - dry * (g.ryr / g.tz);
    const float dpvx = g.v0 ? drx / g.tz : 0.0f;
    const float dpvy = g.v0 ? dry / g.tz : 0.0f;
    const float dpvz = gdep + (g.v0 ? dtz : 0.0f);

    // mean2d = ndc2pix(p_hom * pw) (+ offset)
    const float dpx = gmx * 0.5f * F(a.width);
    const float dpy = gmy * 0.5f * F(a.height);
    const float dph0 = dpx * g.pw, dph1 = dpy * g.pw;
    const float dwh = g.v0 ? -((dpx * g.ph0 + dpy * g.ph1) * (g.pw * g.pw)) : 0.0f;

    // SH colour: coefficients of the active degree, zero above it
    constexpr int K = (DEG + 1) * (DEG + 1);
    const float dxr = x - cam.cc[0], dyr = y - cam.cc[1], dzr = z - cam.cc[2];
    const float dlen = sqrtf((dxr * dxr + dyr * dyr) + dzr * dzr);
    const float ux = dxr / dlen, uy = dyr / dlen, uz = dzr / dlen;
    float b[K];
    sh_basis<DEG>(ux, uy, uz, b);
    float dcol[3];
    for (int ch = 0; ch < 3; ++ch) {
        float color = b[0] * coeff(a, i, 0, ch);
#pragma unroll
        for (int j = 1; j < K; ++j) color = color + b[j] * coeff(a, i, j, ch);
        color = color + 0.5f;
        dcol[ch] = color >= 0.0f ? grgb[ch] : 0.0f;
    }
    for (int ch = 0; ch < 3; ++ch) out.dc[3 * t + ch] = b[0] * dcol[ch];
    float* rest = out.rest + out.k3 * t;
#pragma unroll
    for (int j = 1; j < K; ++j)
        for (int ch = 0; ch < 3; ++ch) rest[(j - 1) * 3 + ch] = b[j] * dcol[ch];
    for (int k = 3 * (K - 1); k < 3 * k_rest; ++k) rest[k] = 0.0f;
    float ddir[3] = {0.0f, 0.0f, 0.0f};
    if (DEG > 0) {
        float db[K];
#pragma unroll
        for (int j = 0; j < K; ++j)
            db[j] = (coeff(a, i, j, 0) * dcol[0] + coeff(a, i, j, 1) * dcol[1])
                    + coeff(a, i, j, 2) * dcol[2];
        float gux, guy, guz;
        sh_dir_grad<DEG>(ux, uy, uz, db, gux, guy, guz);
        float dot = ux * gux;
        dot = dot + uy * guy;
        dot = dot + uz * guz;
        ddir[0] = (gux - ux * dot) / dlen;
        ddir[1] = (guy - uy * dot) / dlen;
        ddir[2] = (guz - uz * dot) / dlen;
    }

    // xyz: projection, view (cov2d and depth), SH direction
    for (int k = 0; k < 3; ++k)
        out.xyz[3 * t + k] = ((P[k] * dph0 + P[4 + k] * dph1) + P[12 + k] * dwh)
                             + ((W[k] * dpvx + W[4 + k] * dpvy) + W[8 + k] * dpvz) + ddir[k];

    // Sigma = R diag(v) R^T, v = (mod s)^2, s = exp(scaling)
    float dR[3][3];
    for (int k = 0; k < 3; ++k) {
        const float a0 = g.R[0][k], a1 = g.R[1][k], a2 = g.R[2][k];
        const float dv = ((((dc[0] * (a0 * a0) + dc[1] * (a0 * a1)) + dc[2] * (a0 * a2))
                           + dc[3] * (a1 * a1)) + dc[4] * (a1 * a2)) + dc[5] * (a2 * a2);
        dR[0][k] = g.v[k] * ((2.0f * dc[0] * a0 + dc[1] * a1) + dc[2] * a2);
        dR[1][k] = g.v[k] * ((dc[1] * a0 + 2.0f * dc[3] * a1) + dc[4] * a2);
        dR[2][k] = g.v[k] * ((dc[2] * a0 + dc[4] * a1) + 2.0f * dc[5] * a2);
        out.scaling[3 * t + k] = 2.0f * g.S[k] * dv * a.scale_modifier * g.s[k];
    }
    const float qr = g.qq[0], qx = g.qq[1], qy = g.qq[2], qz = g.qq[3];
    float dq[4];
    dq[0] = 2.0f * (((((qy * dR[0][2] - qz * dR[0][1]) + qz * dR[1][0]) - qx * dR[1][2])
                     - qy * dR[2][0]) + qx * dR[2][1]);
    dq[1] = 2.0f * ((((((qy * dR[0][1] + qz * dR[0][2]) + qy * dR[1][0]) - 2.0f * qx * dR[1][1])
                      - qr * dR[1][2]) + qz * dR[2][0]) + qr * dR[2][1] - 2.0f * qx * dR[2][2]);
    dq[2] = 2.0f * ((((((qx * dR[0][1] + qr * dR[0][2]) + qx * dR[1][0]) + qz * dR[1][2])
                      - qr * dR[2][0]) + qz * dR[2][1]) - 2.0f * qy * dR[0][0]
                    - 2.0f * qy * dR[2][2]);
    dq[3] = 2.0f * ((((((qx * dR[0][2] - qr * dR[0][1]) + qr * dR[1][0]) + qy * dR[1][2])
                      + qx * dR[2][0]) + qy * dR[2][1]) - 2.0f * qz * dR[0][0]
                    - 2.0f * qz * dR[1][1]);
    // the two normalisations, innermost last
    float dot = g.qq[0] * dq[0];
    for (int k = 1; k < 4; ++k) dot = dot + g.qq[k] * dq[k];
    float dqa[4];
    for (int k = 0; k < 4; ++k) dqa[k] = (dq[k] - g.qq[k] * dot) / g.n1;
    dot = g.qa[0] * dqa[0];
    for (int k = 1; k < 4; ++k) dot = dot + g.qa[k] * dqa[k];
    for (int k = 0; k < 4; ++k) out.rotation[4 * t + k] = (dqa[k] - g.qa[k] * dot) / g.n0;
    out.offset[2 * t] = gmx;
    out.offset[2 * t + 1] = gmy;
}

template <int DEG, bool AA>
__global__ void __launch_bounds__(BLOCK) project_bwd_kernel(
    ProjectParams a, ProjectCotangents ct, ProjectGrads gr)
{
    __shared__ Cam cam;
    extern __shared__ float stage[];  // BLOCK * (Stage::FIXED + 3 k_rest) floats
    load_camera(a, cam);
    Stage out(stage, a.k_rest);
    const int t = threadIdx.x;
    const long long first = (long long)blockIdx.x * BLOCK;
    const int rows = (int)min((long long)BLOCK, a.n - first);
    if (t < rows) {
        if (a.alive[first + t]) bwd_row<DEG, AA>(a, cam, ct, first + t, t, out);
        else out.zero_row(t);
    }
    __syncthreads();
    out.store(gr, first, rows);
}

template <int DEG>
cudaError_t launch_fwd(const ProjectParams& a, const ProjectOutputs& o, bool aa, bool tight,
                       cudaStream_t st)
{
    const unsigned blocks = (unsigned)((a.n + BLOCK - 1) / BLOCK);
    if (aa && tight) project_fwd_kernel<DEG, true, true><<<blocks, BLOCK, 0, st>>>(a, o);
    else if (aa) project_fwd_kernel<DEG, true, false><<<blocks, BLOCK, 0, st>>>(a, o);
    else if (tight) project_fwd_kernel<DEG, false, true><<<blocks, BLOCK, 0, st>>>(a, o);
    else project_fwd_kernel<DEG, false, false><<<blocks, BLOCK, 0, st>>>(a, o);
    return cudaGetLastError();
}

template <int DEG>
cudaError_t launch_bwd(const ProjectParams& a, const ProjectCotangents& c, const ProjectGrads& g,
                       bool aa, cudaStream_t st)
{
    const unsigned blocks = (unsigned)((a.n + BLOCK - 1) / BLOCK);
    const size_t smem = sizeof(float) * BLOCK * (Stage::FIXED + 3 * a.k_rest);
    if (aa) project_bwd_kernel<DEG, true><<<blocks, BLOCK, smem, st>>>(a, c, g);
    else project_bwd_kernel<DEG, false><<<blocks, BLOCK, smem, st>>>(a, c, g);
    return cudaGetLastError();
}

}  // namespace

extern "C" int gs_project_fwd(const ProjectParams* a, const ProjectOutputs* o, int degree,
                              int antialiasing, int tight_cull, void* stream)
{
    if (a->n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (degree) {
    case 0: return launch_fwd<0>(*a, *o, antialiasing, tight_cull, st);
    case 1: return launch_fwd<1>(*a, *o, antialiasing, tight_cull, st);
    case 2: return launch_fwd<2>(*a, *o, antialiasing, tight_cull, st);
    case 3: return launch_fwd<3>(*a, *o, antialiasing, tight_cull, st);
    case 4: return launch_fwd<4>(*a, *o, antialiasing, tight_cull, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int gs_project_bwd(const ProjectParams* a, const ProjectCotangents* c,
                              const ProjectGrads* g, int degree, int antialiasing, void* stream)
{
    if (a->n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (degree) {
    case 0: return launch_bwd<0>(*a, *c, *g, antialiasing, st);
    case 1: return launch_bwd<1>(*a, *c, *g, antialiasing, st);
    case 2: return launch_bwd<2>(*a, *c, *g, antialiasing, st);
    case 3: return launch_bwd<3>(*a, *c, *g, antialiasing, st);
    case 4: return launch_bwd<4>(*a, *c, *g, antialiasing, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
