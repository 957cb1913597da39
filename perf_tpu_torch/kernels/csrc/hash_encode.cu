// hash_encode: the multiresolution hash-grid encode of a level plan's
// points, forward and backward, one thread per (level, point), with linear
// interpolation (the NGP field's) or smoothstep (the sphere field's) as a
// compile-time variant: hash_encode_{fwd,bwd}_launch and
// hash_encode_smooth_{fwd,bwd}_launch.
//
// Replaces (JAX): perf_tpu/kernels/hashgrid.py encode_level_coords, as
// called per level by hash_encode_ray (training, with the per-level ray
// strides of level_strides) and hash_encode_coords (the bake, the
// occupancy prune and the preview: every stride 1; the sphere field's
// hash encoding, perf_tpu/fields/sphere_field.py:86, with smoothstep), and
// its autodiff transpose (the table gradient).
//
// Points: the level plan of ray_points.cuh (the point form is rays of one
// sample). The lerp back to S samples runs around the kernel in PyTorch
// (kernels/hashgrid.py), so the backward receives the coarse points'
// cotangents already summed in float32.
//
// Forward: the 8 corners of each point's cell, their rows and weights as
// hash_cell.cuh finds them (JAX's order and rounding); each feature sums
// table[l][f][row] * weight corner after corner, every float operation
// rounded on its own (no contraction). The table is float32 [L, 2, T]
// (feature-major, JAX's layout), so a corner costs two 4-byte reads, T
// floats apart.
// Backward: for each corner and feature, atomicAdd weight * cotangent in
// float32 into the zeroed [L, 2, T] table gradient (JAX's scatter-add of
// the gather's transpose, no bf16 rounding). No position gradient: the
// wrapper refuses coordinates that require one (the sphere field's comes
// from hash_encode_grad.cu).
//
// What bounds it on the H100: memory. The default grid's f32 tables are
// 2 MiB a level, 32 MiB a head, so one head's table sits in the 50 MB L2;
// per (level, point) the forward reads 12 bytes of coordinates (from L2
// after the first level), 16 scattered 4-byte table entries and writes 8
// bytes; the bound counts the coordinates once, the table once (at most)
// and the output. The backward issues 16 float atomics per (level, point)
// into a 32 MiB gradient, which contend on the coarse dense levels (17^3
// rows at level 0). Float atomics make its sum order change from run to
// run. A first version: no [L, T, 2] scratch layout (one 8-byte read or
// float2 atomic per corner), no warp-level aggregation of atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_cell.cuh"
#include "ray_points.cuh"

namespace {

constexpr int THREADS = 256;

template <bool SMOOTH>
__global__ void __launch_bounds__(THREADS)
hash_fwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                const float* __restrict__ nz, int n_samples,
                const float* __restrict__ table, int table_size,
                const int* __restrict__ levels, int n_levels, long long total,
                float2* __restrict__ out) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    const uint32_t mask = (uint32_t)table_size - 1u;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        long long ray;
        int s;
        const int l = plan_point(g, lv, n_levels, n_samples, ray, s);
        const long long si = ray * n_samples + s;
        const int* row = lv + l * PLAN_COLS;
        const float p[3] = {nx[si], ny[si], nz[si]};
        const HashCell h = hash_cell<SMOOTH, false>(p, row[0]);
        const float* t0 = table + (size_t)l * 2 * table_size;
        const float* t1 = t0 + table_size;
        float a0 = 0.0f, a1 = 0.0f;
        for_hash_corners<false>(h, row[1], row[2], mask, [&](uint32_t r, float w) {
            a0 = __fadd_rn(a0, __fmul_rn(__ldg(t0 + r), w));
            a1 = __fadd_rn(a1, __fmul_rn(__ldg(t1 + r), w));
        });
        out[g] = make_float2(a0, a1);
    }
}

template <bool SMOOTH>
__global__ void __launch_bounds__(THREADS)
hash_bwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                const float* __restrict__ nz, int n_samples, int table_size,
                const int* __restrict__ levels, int n_levels, long long total,
                const float2* __restrict__ grad_out, float* __restrict__ grad_table) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    const uint32_t mask = (uint32_t)table_size - 1u;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        const float2 go = grad_out[g];
        if (go.x == 0.0f && go.y == 0.0f) continue;   // adds only zeros
        long long ray;
        int s;
        const int l = plan_point(g, lv, n_levels, n_samples, ray, s);
        const long long si = ray * n_samples + s;
        const int* row = lv + l * PLAN_COLS;
        const float p[3] = {nx[si], ny[si], nz[si]};
        const HashCell h = hash_cell<SMOOTH, false>(p, row[0]);
        float* d0 = grad_table + (size_t)l * 2 * table_size;
        float* d1 = d0 + table_size;
        for_hash_corners<false>(h, row[1], row[2], mask, [&](uint32_t r, float w) {
            const float c0 = __fmul_rn(go.x, w), c1 = __fmul_rn(go.y, w);
            if (c0 != 0.0f) atomicAdd(d0 + r, c0);
            if (c1 != 0.0f) atomicAdd(d1 + r, c1);
        });
    }
}

template <bool SMOOTH>
int fwd_launch(const void* nx, const void* ny, const void* nz, int n_samples,
               const void* table, int table_size, const void* levels,
               int n_levels, long long total, void* out, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    hash_fwd_kernel<SMOOTH><<<plan_grid(total, THREADS), THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        (const float*)table, table_size, (const int*)levels, n_levels, total,
        (float2*)out);
    return (int)cudaGetLastError();
}

template <bool SMOOTH>
int bwd_launch(const void* nx, const void* ny, const void* nz, int n_samples,
               int table_size, const void* levels, int n_levels, long long total,
               const void* grad_out, void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    hash_bwd_kernel<SMOOTH><<<plan_grid(total, THREADS), THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        table_size, (const int*)levels, n_levels, total,
        (const float2*)grad_out, (float*)grad_table);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hash_encode_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        const void* table, int table_size, const void* levels, int n_levels,
        long long total, void* out, void* stream) {
    return fwd_launch<false>(nx, ny, nz, n_samples, table, table_size, levels,
                             n_levels, total, out, stream);
}

extern "C" int hash_encode_smooth_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        const void* table, int table_size, const void* levels, int n_levels,
        long long total, void* out, void* stream) {
    return fwd_launch<true>(nx, ny, nz, n_samples, table, table_size, levels,
                            n_levels, total, out, stream);
}

extern "C" int hash_encode_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        int table_size, const void* levels, int n_levels, long long total,
        const void* grad_out, void* grad_table, void* stream) {
    return bwd_launch<false>(nx, ny, nz, n_samples, table_size, levels,
                             n_levels, total, grad_out, grad_table, stream);
}

extern "C" int hash_encode_smooth_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        int table_size, const void* levels, int n_levels, long long total,
        const void* grad_out, void* grad_table, void* stream) {
    return bwd_launch<true>(nx, ny, nz, n_samples, table_size, levels,
                            n_levels, total, grad_out, grad_table, stream);
}
