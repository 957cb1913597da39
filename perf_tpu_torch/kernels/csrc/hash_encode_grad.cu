// hash_encode_grad: the hash-grid encode of points with its derivatives with
// respect to the position, forward and backward, one thread per (point,
// level), with smoothstep interpolation (the sphere field's; the linear NGP
// field never asks for the position gradient).
//
// Replaces (JAX): the jax.vjp of perf_tpu/fields/sphere_field.py:144-147
// through hash_encode (perf_tpu/kernels/hashgrid.py:208, encode_level_coords
// :104 with _axis_terms :92-101): the sphere field's `ad` gradient mode, in
// which the distance's direction gradient is differentiated again by the
// training loss (second order in JAX). The port computes the direction
// gradient forward (this kernel's dfeats, then the MLP's jvp in PyTorch), so
// the loss needs only the first-order table gradient of (feats, dfeats),
// which the backward gives.
//
// Forward, per (point n, level l): the 8 corners of the point's cell with
// their rows, weights and the weights' derivatives per axis as
// hash_cell.cuh finds them (JAX's order and forward-mode arithmetic);
// feats[n, 2l + f] sums table[l][f][row] * weight, dfeats[n, a, 2l + f]
// sums table[l][f][row] * dweight_a, corner after corner. Every float
// operation is rounded on its own (no contraction), in the order written.
//
// Backward: per corner and feature, ((weight * gf + dwx * gx) + dwy * gy)
// + dwz * gz from the cotangents of feats (gf) and dfeats (gx, gy, gz),
// added with a float32 atomicAdd into the zeroed [L, 2, T] table gradient.
// The position cotangent is not computed (the points are data).
//
// What bounds it on the H100: memory and latency. Per (point, level) 16
// scattered 4-byte table reads from a float32 [L, 2, T] table (the sphere
// field's 16 x 2^19 rows are 64 MiB: the finest levels fall out of the
// 50 MB L2), 12 bytes of point (once per point, from L2 after the first
// level) and 32 bytes written. The backward's 16 float atomics per (point,
// level) contend on the coarse dense levels (17^3 rows at level 0 for the
// joint predictor's fine_res 2048). A first version: no warp-level
// aggregation of atomics, no [L, T, 2] layout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_cell.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 32;

__device__ __forceinline__ void load_levels(int* lv, const int* __restrict__ levels,
                                            int n_levels) {
    for (int i = threadIdx.x; i < n_levels * 3; i += blockDim.x) lv[i] = levels[i];
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
grad_fwd_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ table, int table_size,
                const int* __restrict__ levels, int n_levels,
                float* __restrict__ feats, float* __restrict__ dfeats) {
    __shared__ int lv[MAX_LEVELS * 3];
    load_levels(lv, levels, n_levels);
    const uint32_t mask = (uint32_t)table_size - 1u;
    const long long total = n * n_levels;
    const int width = 2 * n_levels;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        const long long p = g / n_levels;
        const int l = (int)(g - p * n_levels);
        const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
        const HashCell h = hash_cell<true, true>(xp, lv[3 * l]);
        const float* t0 = table + (size_t)l * 2 * table_size;
        const float* t1 = t0 + table_size;
        float f0 = 0.0f, f1 = 0.0f;
        float d0[3] = {0.0f, 0.0f, 0.0f}, d1[3] = {0.0f, 0.0f, 0.0f};
        for_hash_corners<true>(h, lv[3 * l + 1], lv[3 * l + 2], mask,
                               [&](uint32_t r, float w, float wx, float wy, float wz) {
            const float v0 = __ldg(t0 + r), v1 = __ldg(t1 + r);
            f0 = __fadd_rn(f0, __fmul_rn(v0, w));
            f1 = __fadd_rn(f1, __fmul_rn(v1, w));
            d0[0] = __fadd_rn(d0[0], __fmul_rn(v0, wx));
            d1[0] = __fadd_rn(d1[0], __fmul_rn(v1, wx));
            d0[1] = __fadd_rn(d0[1], __fmul_rn(v0, wy));
            d1[1] = __fadd_rn(d1[1], __fmul_rn(v1, wy));
            d0[2] = __fadd_rn(d0[2], __fmul_rn(v0, wz));
            d1[2] = __fadd_rn(d1[2], __fmul_rn(v1, wz));
        });
        reinterpret_cast<float2*>(feats + p * width)[l] = make_float2(f0, f1);
#pragma unroll
        for (int a = 0; a < 3; ++a)
            reinterpret_cast<float2*>(dfeats + (p * 3 + a) * width)[l] =
                make_float2(d0[a], d1[a]);
    }
}

__global__ void __launch_bounds__(THREADS)
grad_bwd_kernel(const float* __restrict__ x, long long n, int table_size,
                const int* __restrict__ levels, int n_levels,
                const float* __restrict__ g_feats,
                const float* __restrict__ g_dfeats,
                float* __restrict__ grad_table) {
    __shared__ int lv[MAX_LEVELS * 3];
    load_levels(lv, levels, n_levels);
    const uint32_t mask = (uint32_t)table_size - 1u;
    const long long total = n * n_levels;
    const int width = 2 * n_levels;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
         g += (long long)gridDim.x * blockDim.x) {
        const long long p = g / n_levels;
        const int l = (int)(g - p * n_levels);
        const float2 gf = reinterpret_cast<const float2*>(g_feats + p * width)[l];
        float2 gd[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            gd[a] = reinterpret_cast<const float2*>(g_dfeats + (p * 3 + a) * width)[l];
        if (gf.x == 0.0f && gf.y == 0.0f && gd[0].x == 0.0f && gd[0].y == 0.0f
            && gd[1].x == 0.0f && gd[1].y == 0.0f && gd[2].x == 0.0f
            && gd[2].y == 0.0f)
            continue;                                   // adds only zeros
        const float xp[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
        const HashCell h = hash_cell<true, true>(xp, lv[3 * l]);
        float* o0 = grad_table + (size_t)l * 2 * table_size;
        float* o1 = o0 + table_size;
        for_hash_corners<true>(h, lv[3 * l + 1], lv[3 * l + 2], mask,
                               [&](uint32_t r, float w, float wx, float wy, float wz) {
            float c0 = __fmul_rn(w, gf.x), c1 = __fmul_rn(w, gf.y);
            c0 = __fadd_rn(c0, __fmul_rn(wx, gd[0].x));
            c1 = __fadd_rn(c1, __fmul_rn(wx, gd[0].y));
            c0 = __fadd_rn(c0, __fmul_rn(wy, gd[1].x));
            c1 = __fadd_rn(c1, __fmul_rn(wy, gd[1].y));
            c0 = __fadd_rn(c0, __fmul_rn(wz, gd[2].x));
            c1 = __fadd_rn(c1, __fmul_rn(wz, gd[2].y));
            if (c0 != 0.0f) atomicAdd(o0 + r, c0);
            if (c1 != 0.0f) atomicAdd(o1 + r, c1);
        });
    }
}

inline unsigned grid_of(long long total) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}

inline int check_args(long long n, int table_size, int n_levels) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (n < 0) return (int)cudaErrorInvalidValue;
    return (int)cudaSuccess;
}

}  // namespace

extern "C" int hash_encode_grad_fwd_launch(
        const void* x, long long n, const void* table, int table_size,
        const void* levels, int n_levels, void* feats, void* dfeats,
        void* stream) {
    const int err = check_args(n, table_size, n_levels);
    if (err != (int)cudaSuccess) return err;
    if (n == 0) return (int)cudaSuccess;
    const long long total = n * n_levels;
    grad_fwd_kernel<<<grid_of(total), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, (const float*)table, table_size,
        (const int*)levels, n_levels, (float*)feats, (float*)dfeats);
    return (int)cudaGetLastError();
}

extern "C" int hash_encode_grad_bwd_launch(
        const void* x, long long n, int table_size, const void* levels,
        int n_levels, const void* g_feats, const void* g_dfeats,
        void* grad_table, void* stream) {
    const int err = check_args(n, table_size, n_levels);
    if (err != (int)cudaSuccess) return err;
    if (n == 0) return (int)cudaSuccess;
    const long long total = n * n_levels;
    grad_bwd_kernel<<<grid_of(total), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, table_size, (const int*)levels, n_levels,
        (const float*)g_feats, (const float*)g_dfeats, (float*)grad_table);
    return (int)cudaGetLastError();
}
