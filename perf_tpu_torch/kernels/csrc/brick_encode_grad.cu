// brick_encode_grad: the sphere field's stacked-level brick encode with its
// in-cell derivatives, forward and backward, one thread per (point, level).
//
// Replaces (JAX): perf_tpu/kernels/brickgrid.py corner_interp_grad_lowp with
// its custom VJP (_cig_fwd / _cig_bwd), as called by
// brick_encode_stacked_grad, which the sphere distance field's analytic
// gradients (perf_tpu/fields/sphere_field.py) run on every distillation step
// and on the full-resolution readback.
//
// Forward, per (point n, level l) at level resolution res (smoothstep
// interpolation, the sphere field's):
//   pos = clip(x, 0, 1) * res; c0 = clip(floor(pos), 0, res - 1);
//   f = pos - c0; chain = ((res * [0 < x < 1] * 6) * f) * (1 - f),
//   f = (f * f) * (3 - 2 f);
// brick b = c0 / 3 at local cell c0 % 3; the row is dense or the uint32 prime
// hash (brick_common.cuh's brick_row) of level l's [rows, 128] bf16 slice.
// Over the 8 interpolation corners: feature += v * ((wx * wy) * wz) and, per
// axis, derivative += v * ((dx * wy) * wz) (dx = -1 at the lower corner, +1
// at the upper), then each derivative is multiplied by its axis' chain.
// Out: feats [N, L * 2] and dfeats [N, 3, L * 2], level-major (l * 2 + f).
//
// Backward: the cotangents of the feature and of the three chained
// derivatives are combined per corner in float32 in JAX's order,
// ((w * gf + (dx wy wz) * gx) + (wx dy wz) * gy) + (wx wy dz) * gz with
// g_axis = dfeats cotangent * chain, rounded to bf16 once (JAX rounds the
// combined row), and added with a float32 atomicAdd into the zeroed
// [L, rows, 128] table gradient. The position cotangent is zero by design.
//
// What bounds it on the H100: per (point, level) one 32-byte read of scattered
// corners from an 8 MB bf16 sphere table (L2-resident), 12 bytes of
// direction and 32 bytes of output (feature and 3 derivatives, 2 features);
// the backward issues up to 16 float atomics per (point, level) into a 67 MB
// gradient. At the distillation's 15k points per step both are launch-bound;
// at the readback's 2M points memory sets the time. A first version: no
// warp-level aggregation of atomics to the same row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "brick_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 32;
constexpr int ROW = 128;       // 64 corners x 2 features

struct GradCorner {
    BrickCorner c;   // row, cell and smoothed fractions
    float chain[3];  // d fraction / d x per axis
};

__device__ __forceinline__ GradCorner locate_grad(const float* x, int res, int nb,
                                                  int hashed, int rows) {
    GradCorner g;
    int b[3];
    const float fres = (float)res;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float pos = __fmul_rn(fminf(fmaxf(x[a], 0.0f), 1.0f), fres);
        const float c0f = fminf(fmaxf(floorf(pos), 0.0f), (float)(res - 1));
        float fr = __fsub_rn(pos, c0f);
        const float inside = (x[a] > 0.0f && x[a] < 1.0f) ? fres : 0.0f;
        const float dfr = __fmul_rn(__fmul_rn(__fmul_rn(inside, 6.0f), fr),
                                    __fsub_rn(1.0f, fr));
        fr = __fmul_rn(__fmul_rn(fr, fr), __fsub_rn(3.0f, __fmul_rn(2.0f, fr)));
        const int c0 = (int)c0f;
        b[a] = c0 / 3;
        g.c.loc[a] = c0 - b[a] * 3;
        g.c.fr[a] = fr;
        g.chain[a] = dfr;
    }
    g.c.row = brick_row(b[0], b[1], b[2], nb, hashed, rows);
    return g;
}

// Calls f(corner, w, dwx, dwy, dwz) for the 8 corners: w = (wx * wy) * wz and
// the three derivative weights (dx * wy) * wz, (wx * dy) * wz, (wx * wy) * dz.
template <class F>
__device__ __forceinline__ void for_grad_corners(const BrickCorner& c, F&& f) {
#pragma unroll
    for (int ox = 0; ox < 2; ++ox) {
        const float wx = ox ? c.fr[0] : __fsub_rn(1.0f, c.fr[0]);
        const float dx = ox ? 1.0f : -1.0f;
#pragma unroll
        for (int oy = 0; oy < 2; ++oy) {
            const float wy = oy ? c.fr[1] : __fsub_rn(1.0f, c.fr[1]);
            const float dy = oy ? 1.0f : -1.0f;
#pragma unroll
            for (int oz = 0; oz < 2; ++oz) {
                const float wz = oz ? c.fr[2] : __fsub_rn(1.0f, c.fr[2]);
                const float dz = oz ? 1.0f : -1.0f;
                f(((c.loc[0] + ox) * 4 + (c.loc[1] + oy)) * 4 + (c.loc[2] + oz),
                  __fmul_rn(__fmul_rn(wx, wy), wz),
                  __fmul_rn(__fmul_rn(dx, wy), wz),
                  __fmul_rn(__fmul_rn(wx, dy), wz),
                  __fmul_rn(__fmul_rn(wx, wy), dz));
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
encode_grad_fwd_kernel(const float* __restrict__ x, long long n,
                       const __nv_bfloat16* __restrict__ table, int rows,
                       const int* __restrict__ levels, int n_levels,
                       float* __restrict__ feats, float* __restrict__ dfeats) {
    __shared__ int lv[3 * MAX_LEVELS];
    for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x) lv[i] = levels[i];
    __syncthreads();
    const long long total = n * n_levels;
    const int width = 2 * n_levels;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (long long)gridDim.x * blockDim.x) {
        const long long p = t / n_levels;
        const int l = (int)(t - p * n_levels);
        const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
        const GradCorner g = locate_grad(xp, lv[3 * l], lv[3 * l + 1], lv[3 * l + 2],
                                         rows);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(
            table + ((size_t)l * rows + g.c.row) * ROW);
        float acc[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
        for_grad_corners(g.c, [&](int corner, float w, float wdx, float wdy,
                                  float wdz) {
            const float2 v = __bfloat1622float2(__ldg(r2 + corner));
            const float ws[4] = {w, wdx, wdy, wdz};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                acc[k][0] = __fadd_rn(acc[k][0], __fmul_rn(v.x, ws[k]));
                acc[k][1] = __fadd_rn(acc[k][1], __fmul_rn(v.y, ws[k]));
            }
        });
        feats[p * width + 2 * l] = acc[0][0];
        feats[p * width + 2 * l + 1] = acc[0][1];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float* d = dfeats + (p * 3 + a) * width + 2 * l;
            d[0] = __fmul_rn(acc[a + 1][0], g.chain[a]);
            d[1] = __fmul_rn(acc[a + 1][1], g.chain[a]);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
encode_grad_bwd_kernel(const float* __restrict__ x, long long n, int rows,
                       const int* __restrict__ levels, int n_levels,
                       const float* __restrict__ g_feats,
                       const float* __restrict__ g_dfeats,
                       float* __restrict__ grad_table) {
    __shared__ int lv[3 * MAX_LEVELS];
    for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x) lv[i] = levels[i];
    __syncthreads();
    const long long total = n * n_levels;
    const int width = 2 * n_levels;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (long long)gridDim.x * blockDim.x) {
        const long long p = t / n_levels;
        const int l = (int)(t - p * n_levels);
        const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
        const GradCorner g = locate_grad(xp, lv[3 * l], lv[3 * l + 1], lv[3 * l + 2],
                                         rows);
        float gk[4][2];
        gk[0][0] = g_feats[p * width + 2 * l];
        gk[0][1] = g_feats[p * width + 2 * l + 1];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float* d = g_dfeats + (p * 3 + a) * width + 2 * l;
            gk[a + 1][0] = __fmul_rn(d[0], g.chain[a]);
            gk[a + 1][1] = __fmul_rn(d[1], g.chain[a]);
        }
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) any |= (gk[k][0] != 0.0f) | (gk[k][1] != 0.0f);
        if (!any) continue;                       // adds only zeros
        float* dst = grad_table + ((size_t)l * rows + g.c.row) * ROW;
        for_grad_corners(g.c, [&](int corner, float w, float wdx, float wdy,
                                  float wdz) {
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                float cot = __fmul_rn(w, gk[0][f]);
                cot = __fadd_rn(cot, __fmul_rn(wdx, gk[1][f]));
                cot = __fadd_rn(cot, __fmul_rn(wdy, gk[2][f]));
                cot = __fadd_rn(cot, __fmul_rn(wdz, gk[3][f]));
                const float r = __bfloat162float(__float2bfloat16_rn(cot));
                if (r != 0.0f) atomicAdd(dst + 2 * corner + f, r);
            }
        });
    }
}

unsigned grid_for(long long total) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int brick_encode_grad_fwd_launch(const void* x, long long n,
                                            const void* table, int rows,
                                            const void* levels, int n_levels,
                                            void* feats,
                                            void* dfeats, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    encode_grad_fwd_kernel<<<grid_for(n * n_levels), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, n, (const __nv_bfloat16*)table, rows,
        (const int*)levels, n_levels, (float*)feats, (float*)dfeats);
    return (int)cudaGetLastError();
}

extern "C" int brick_encode_grad_bwd_launch(const void* x, long long n, int rows,
                                            const void* levels, int n_levels,
                                            const void* g_feats,
                                            const void* g_dfeats,
                                            void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    encode_grad_bwd_kernel<<<grid_for(n * n_levels), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)x, n, rows, (const int*)levels, n_levels,
        (const float*)g_feats, (const float*)g_dfeats, (float*)grad_table);
    return (int)cudaGetLastError();
}
