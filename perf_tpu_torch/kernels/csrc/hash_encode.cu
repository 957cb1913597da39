// hash_encode: the multiresolution hash-grid encode (linear interpolation)
// of a level plan's points, forward and backward, one thread per (level,
// point).
//
// Replaces (JAX): perf_tpu/kernels/hashgrid.py encode_level_coords, as
// called per level by hash_encode_ray (training, with the per-level ray
// strides of level_strides) and hash_encode_coords (the bake, the
// occupancy prune and the preview: every stride 1), and its autodiff
// transpose (the table gradient).
//
// Points: the level plan of ray_points.cuh (the point form is rays of one
// sample). The lerp back to S samples runs around the kernel in PyTorch
// (kernels/hashgrid.py), so the backward receives the coarse points'
// cotangents already summed in float32.
//
// Forward: per axis pos = clamp(x, 0, 1) * res, lower corner
// c0 = clamp(floor(pos), 0, res - 1), weight frac = pos - c0. The 8 corners
// in JAX's order (ox, oy, oz) = (0,0,0), (0,0,1), ..., (1,1,1); each
// corner's row is dense, (cx * (res+1) + cy) * (res+1) + cz, where the
// level's (res+1)^3 corners fit the T rows, else the uint32 prime hash
// (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) masked to T - 1. Weight
// (wx * wy) * wz with 1 - w for a lower corner; each feature sums
// table[l][f][row] * weight corner after corner. Every float operation is
// rounded as JAX rounds it (no contraction). The table is float32 [L, 2, T]
// (feature-major, JAX's layout), so a corner costs two 4-byte reads, T
// floats apart.
// Backward: for each corner and feature, atomicAdd weight * cotangent in
// float32 into the zeroed [L, 2, T] table gradient (JAX's scatter-add of
// the gather's transpose, no bf16 rounding). No position gradient: the
// NeRF path never asks for one, and the wrapper refuses coordinates that
// require one.
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

#include "ray_points.cuh"

namespace {

constexpr int THREADS = 256;

struct HashCell {
    int c[3];        // the lower corner per axis
    float fr[3];     // the linear weight of the upper corner per axis
};

__device__ __forceinline__ HashCell hash_cell(float x, float y, float z, int res) {
    HashCell h;
    const float p[3] = {x, y, z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float pos = __fmul_rn(fminf(fmaxf(p[a], 0.0f), 1.0f), (float)res);
        const float c0f = fminf(fmaxf(floorf(pos), 0.0f), (float)(res - 1));
        h.fr[a] = __fsub_rn(pos, c0f);
        h.c[a] = (int)c0f;
    }
    return h;
}

__device__ __forceinline__ uint32_t corner_row(int cx, int cy, int cz, int r1,
                                               int hashed, uint32_t mask) {
    if (hashed)
        return ((uint32_t)cx * 1u ^ (uint32_t)cy * 2654435761u
                ^ (uint32_t)cz * 805459861u) & mask;
    return (uint32_t)((cx * r1 + cy) * r1 + cz);
}

// Calls f(row, w) for the 8 corners of h in JAX's order.
template <class F>
__device__ __forceinline__ void for_corners(const HashCell& h, int r1, int hashed,
                                            uint32_t mask, F&& f) {
#pragma unroll
    for (int ox = 0; ox < 2; ++ox) {
        const float wx = ox ? h.fr[0] : __fsub_rn(1.0f, h.fr[0]);
#pragma unroll
        for (int oy = 0; oy < 2; ++oy) {
            const float wy = oy ? h.fr[1] : __fsub_rn(1.0f, h.fr[1]);
            const float wxy = __fmul_rn(wx, wy);
#pragma unroll
            for (int oz = 0; oz < 2; ++oz) {
                const float wz = oz ? h.fr[2] : __fsub_rn(1.0f, h.fr[2]);
                f(corner_row(h.c[0] + ox, h.c[1] + oy, h.c[2] + oz, r1, hashed,
                             mask),
                  __fmul_rn(wxy, wz));
            }
        }
    }
}

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
        const HashCell h = hash_cell(nx[si], ny[si], nz[si], row[0]);
        const float* t0 = table + (size_t)l * 2 * table_size;
        const float* t1 = t0 + table_size;
        float a0 = 0.0f, a1 = 0.0f;
        for_corners(h, row[1], row[2], mask, [&](uint32_t r, float w) {
            a0 = __fadd_rn(a0, __fmul_rn(__ldg(t0 + r), w));
            a1 = __fadd_rn(a1, __fmul_rn(__ldg(t1 + r), w));
        });
        out[g] = make_float2(a0, a1);
    }
}

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
        const HashCell h = hash_cell(nx[si], ny[si], nz[si], row[0]);
        float* d0 = grad_table + (size_t)l * 2 * table_size;
        float* d1 = d0 + table_size;
        for_corners(h, row[1], row[2], mask, [&](uint32_t r, float w) {
            const float c0 = __fmul_rn(go.x, w), c1 = __fmul_rn(go.y, w);
            if (c0 != 0.0f) atomicAdd(d0 + r, c0);
            if (c1 != 0.0f) atomicAdd(d1 + r, c1);
        });
    }
}

}  // namespace

extern "C" int hash_encode_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        const void* table, int table_size, const void* levels, int n_levels,
        long long total, void* out, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    hash_fwd_kernel<<<plan_grid(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        (const float*)table, table_size, (const int*)levels, n_levels, total,
        (float2*)out);
    return (int)cudaGetLastError();
}

extern "C" int hash_encode_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples,
        int table_size, const void* levels, int n_levels, long long total,
        const void* grad_out, void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    hash_bwd_kernel<<<plan_grid(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        table_size, (const int*)levels, n_levels, total,
        (const float2*)grad_out, (float*)grad_table);
    return (int)cudaGetLastError();
}
