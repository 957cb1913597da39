// hash_encode: the multiresolution hash-grid encode of the ray-structured
// training samples and of points, with linear interpolation (the NGP
// field's) or smoothstep (the sphere field's) as a compile-time variant:
// the forward writes the finished features (hash_encode_fwd_launch,
// hash_encode_smooth_fwd_launch), the backward takes the coarse points'
// cotangents (hash_encode_bwd_launch, hash_encode_smooth_bwd_launch).
//
// Replaces (JAX): perf_tpu/kernels/hashgrid.py hash_encode_ray (training:
// encode_level_coords per level at the strides of level_strides, each
// level lerped back to the S samples by _lerp_upsample, the levels
// stacked) and hash_encode_coords (the bake, the occupancy prune, the
// preview, the proposal fields; the sphere field's hash encoding,
// perf_tpu/fields/sphere_field.py:86, with smoothstep: every stride 1, rays
// of one sample), and their autodiff transpose (the table gradient).
//
// Forward: ray_points.cuh's tile encode with HashLevels (hash_cell.cuh):
// a block stages a tile of rays' coordinates in shared memory, encodes
// every level's coarse points of the tile (the 8 corners of each point's
// cell, their rows and weights in JAX's order and rounding; each feature
// sums table[l][f][row] * weight corner after corner, no contraction), and
// writes the tile's [rays, S, 2L] float32 rows with 16-byte stores, the
// lerp of strided levels done on the way. The parameter stays float32
// [L, 2, T] (feature-major, JAX's layout), where a corner's two features
// lie T floats apart in two 32-byte sectors; the wrapper hands the kernel
// an interleaved [L, T, 2] copy made per call, one 8-byte read a corner.
// On an H100 the copy and the kernel took 0.31 ms against 0.53 ms reading
// [L, 2, T] at the hash geometry phase's 8192 x 128 plan
// (tools/encode_probe.py; PERF.md).
// Backward: one thread per (level, coarse point) of the level plan; for
// each corner and feature, atomicAdd weight * cotangent in float32 into
// the zeroed [L, 2, T] table gradient (JAX's scatter-add of the gather's
// transpose, no bf16 rounding). The wrapper turns the features' cotangent
// into the coarse points' with the lerp's and the stack's transpose in
// PyTorch. No position gradient: the wrapper refuses coordinates that
// require one (the sphere field's comes from hash_encode_grad.cu).
//
// What bounds it on the H100: memory. The default grid's f32 tables are
// 2 MiB a level, 32 MiB a head, so one head's table sits in the 50 MB L2.
// The forward reads the coordinates once (12 bytes a sample), 8 scattered
// 8-byte table entries a coarse point (8 L2 sectors, by hypothesis its
// limit: no counter was read), and writes 8L bytes a sample (128 at 16
// levels), which at the training shapes outweighs the coordinates ten to
// one. The backward issues 16 float atomics per (level, point) into a
// 32 MiB gradient, which contend on the coarse dense levels (17^3 rows at
// level 0). Float atomics make its sum order change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_cell.cuh"
#include "ray_points.cuh"

namespace {

constexpr int THREADS = 256;

template <bool SMOOTH>
__global__ void __launch_bounds__(TILE_THREADS)
hash_ray_fwd_kernel(TileArgs a, HashLevels<SMOOTH> enc) {
    ray_encode_tile(a, enc);
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
int fwd_launch(const void* nx, const void* ny, const void* nz, int n_rays,
               int n_samples, int per_ray, const void* table, int table_size,
               const void* levels, int n_levels, void* out, void* stream) {
    if (table_size < 1 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    const HashLevels<SMOOTH> enc = {(const float2*)table, table_size,
                                    (uint32_t)table_size - 1u};
    return launch_ray_tile(hash_ray_fwd_kernel<SMOOTH>, enc, nx, ny, nz,
                           n_rays, n_samples, per_ray, levels, n_levels, out,
                           stream);
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
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int table_size,
        const void* levels, int n_levels, void* out, void* stream) {
    return fwd_launch<false>(nx, ny, nz, n_rays, n_samples, per_ray, table,
                             table_size, levels, n_levels, out, stream);
}

extern "C" int hash_encode_smooth_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int table_size,
        const void* levels, int n_levels, void* out, void* stream) {
    return fwd_launch<true>(nx, ny, nz, n_rays, n_samples, per_ray, table,
                            table_size, levels, n_levels, out, stream);
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
