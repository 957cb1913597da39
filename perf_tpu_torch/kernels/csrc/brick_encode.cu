// brick_encode: the ray-structured brick-grid encode of the training path,
// forward and backward, one thread per (level, coarse point).
//
// Replaces (JAX): perf_tpu/kernels/brickgrid.py corner_interp_lowp with its
// custom VJP (_ci_fwd / _ci_bwd), as called per level by brick_encode_ray
// with the per-level ray strides of hashgrid.level_strides.
//
// Points: the level plan of ray_points.cuh. The lerp back to S samples
// runs around the kernel in PyTorch (kernels/brickgrid.py), so the backward
// receives the coarse points' cotangents already summed in float32, as
// JAX's transpose of the lerp delivers them.
//
// Forward: find the point's brick row (dense, or the uint32 prime hash
// masked to the table), read the 8 interpolation corners' two bf16 features
// from the row and weight them with the factored trilinear weights
// (wx * wy) * wz, in JAX's operation order; write the 2 features in f32.
// The lookup and weights are brick_common.cuh's, shared with field_eval.cu.
// Backward: for each corner and feature, round w * g to bf16 (JAX rounds
// each lane's contribution before the scatter), then atomicAdd it in f32
// into the zeroed [L, R, 128] table gradient. No position gradient: the
// NeRF path never asks for one (JAX's DCE drops it).
//
// What bounds it on the H100: memory. Per point, one 32-byte read of
// scattered corners from a 16 MB bf16 table that sits in L2, 12 bytes of
// coordinates, 8 bytes out; the backward issues 16 float atomics per point
// into a 33.5 MB gradient, which contend on the coarse levels (216 dense
// rows at level 0). Float atomics make the backward's sum order change from
// run to run. A first version: no shared-memory staging, no warp-level
// aggregation of atomics to the same row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "brick_common.cuh"
#include "ray_points.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 128;       // 64 corners x 2 features
constexpr int LV = PLAN_COLS;  // res, nb, hashed, stride, npts, first point

__global__ void __launch_bounds__(THREADS)
brick_fwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                 const float* __restrict__ nz, int n_samples,
                 const __nv_bfloat16* __restrict__ table, int rows,
                 const int* __restrict__ levels, int n_levels, long long total,
                 float* __restrict__ out) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        long long ray;
        int s;
        const int l = plan_point(g, lv, n_levels, n_samples, ray, s);
        const long long si = ray * n_samples + s;
        const BrickCorner c = brick_locate(nx[si], ny[si], nz[si], lv[l * LV],
                                           lv[l * LV + 1], lv[l * LV + 2], rows);
        const float2 f = brick_interp(c, table + ((size_t)l * rows + c.row) * ROW);
        out[2 * g] = f.x;
        out[2 * g + 1] = f.y;
    }
}

__global__ void __launch_bounds__(THREADS)
brick_bwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                 const float* __restrict__ nz, int n_samples, int rows,
                 const int* __restrict__ levels, int n_levels, long long total,
                 const float* __restrict__ grad_out, float* __restrict__ grad_table) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        const float g0 = grad_out[2 * g], g1 = grad_out[2 * g + 1];
        if (g0 == 0.0f && g1 == 0.0f) continue;   // adds only zeros
        long long ray;
        int s;
        const int l = plan_point(g, lv, n_levels, n_samples, ray, s);
        const long long si = ray * n_samples + s;
        const BrickCorner c = brick_locate(nx[si], ny[si], nz[si], lv[l * LV],
                                           lv[l * LV + 1], lv[l * LV + 2], rows);
        float* dst = grad_table + ((size_t)l * rows + c.row) * ROW;
        brick_for_corners(c, [&](int corner, float w) {
            float c0 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, g0)));
            float c1 = __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, g1)));
            if (c0 != 0.0f) atomicAdd(dst + 2 * corner, c0);
            if (c1 != 0.0f) atomicAdd(dst + 2 * corner + 1, c1);
        });
    }
}

}  // namespace

extern "C" int brick_encode_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        const void* table, int rows, const void* levels, int n_levels,
        long long total, void* out, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    brick_fwd_kernel<<<plan_grid(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        (const __nv_bfloat16*)table, rows, (const int*)levels, n_levels, total,
        (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int brick_encode_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples, int rows,
        const void* levels, int n_levels, long long total, const void* grad_out,
        void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    brick_bwd_kernel<<<plan_grid(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples, rows,
        (const int*)levels, n_levels, total, (const float*)grad_out,
        (float*)grad_table);
    return (int)cudaGetLastError();
}
