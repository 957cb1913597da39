// brick_encode: the ray-structured brick-grid encode of the training path,
// forward (ray_points.cuh's tile encode: the finished [N, S, 2L] features)
// and backward (one warp per 32 consecutive coarse points).
//
// Replaces (JAX): perf_tpu/kernels/brickgrid.py brick_encode_ray
// (corner_interp_lowp per level at the strides of hashgrid.level_strides,
// each level lerped back to the S samples by _lerp_upsample, the levels
// stacked) with corner_interp_lowp's custom VJP (_ci_fwd / _ci_bwd).
//
// Forward: a block stages a tile of rays' coordinates in shared memory,
// encodes every level's coarse points of the tile with BrickLevels
// (brick_common.cuh, shared with field_eval.cu: find the point's brick row,
// dense or the uint32 prime hash masked to the table, read the 8
// interpolation corners' two bf16 features from the row and weight them
// with the factored trilinear weights (wx * wy) * wz in JAX's order) and
// writes the tile's [rays, S, 2L] float32 rows with 16-byte stores, the
// lerp of strided levels done on the way. What bounds it: memory; a
// coarse point reads 32 bytes of scattered corners (2 to 4 sectors) from a
// 16 MB bf16 table that sits in L2, the coordinates are read once (12
// bytes a sample) and each sample's row of 8L bytes is written once (128
// at 16 levels: the largest term at the training shapes). On an H100 a
// larger table lost more than fewer sectors a point gained: float32 rows
// and rows repacked to 2 sectors a point at 1.5x the bytes were both
// slower (PERF.md).
//
// Points of the backward: the level plan of ray_points.cuh. The wrapper
// turns the features' cotangent into the coarse points' with the lerp's
// and the stack's transpose in PyTorch, so the backward receives them
// summed in float32, as JAX's transpose of the lerp delivers them.
//
// Backward: JAX's rule is that each single contribution w * g of a corner
// and feature is rounded to bf16 before any sum, and every sum is float32;
// points whose two cotangents are 0 add nothing and are skipped. What
// bounds it on the H100: not the bytes (coordinates and cotangents in, the
// 33.5 MB float32 [L, R, 128] gradient written once: ~0.02 ms) but, as a
// hypothesis (no counter was read), the number of atomics L2 retires. A
// point has 8 corners x 2 features; the plan numbers points ray after ray, so neighbouring points are consecutive
// samples of one ray at one level, which mostly fall in one brick row and
// often in one voxel, and the dense coarse levels (216, 512 and 1,728 rows)
// take every ray's coarse points. One float atomic per corner and feature
// from each point (16 a point) then serialises in L2 on a few addresses.
// The design:
//   - a warp takes 32 consecutive points of the plan (grid-stride over
//     warps); each lane locates its point once and rounds its 16
//     contributions to bf16;
//   - the lanes whose points share a voxel (level, row and cell: the same
//     8 corners) form runs along the ray; a segmented reduction by warp
//     shuffles, as many steps as the warp's longest run needs and none
//     when no two neighbours share a voxel, leaves each run's float32 sums
//     in its first lane;
//   - that lane adds them with float4 atomics (Hopper's vector float
//     atomics on global memory): a corner's two features are adjacent
//     floats and the oz = 0, 1 corners adjacent float2s, so a pair of
//     corners is one float4 when it is 16-byte aligned and two zero-padded
//     ones when not: 4 to 6 atomics a run instead of 16 a point.
// Keying the runs by voxel and not by corner leaves unmerged the corners
// that neighbouring voxels share, but takes one key and one reduction of
// 16 floats instead of eight of 2,
// and lets the 8 corners go out as float4s. The order of float additions
// differs from the plain version's (and, through the atomics, from run to
// run); each addend is the same bf16 value. A per-block shared-memory slab
// of the dense level 0 (216 x 128 x 4 B = 110.6 KB) was not built: a ray
// has few level-0 points, whose runs merge, and flushing a slab once per
// block would add up to 6,912 float4 atomics (the slab) a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "brick_common.cuh"
#include "ray_points.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 128;       // 64 corners x 2 features
constexpr int LV = PLAN_COLS;  // res, nb, hashed, stride, npts, first point

__global__ void __launch_bounds__(TILE_THREADS)
brick_ray_fwd_kernel(TileArgs a, BrickLevels enc) {
    ray_encode_tile(a, enc);
}

// The plan's level of point g (g < 2^31) and the sample it reads: returns
// the level, sets the sample's flat index ray * n_samples + s, in int: the
// wrapper keeps points and samples below 2^31.
__device__ __forceinline__ int point_sample(int g, const int* lv, int n_levels,
                                            int n_samples, int& si) {
    int l = 0;
    while (l + 1 < n_levels && g >= lv[(l + 1) * LV + 5]) ++l;
    const int k = lv[l * LV + 3], npts = lv[l * LV + 4];
    const int local = g - lv[l * LV + 5];
    const int ray = local / npts;
    const int p = local - ray * npts;
    si = ray * n_samples
         + ((k == 1) ? p : (p == npts - 1 ? n_samples - 1 : p * k));
    return l;
}

constexpr unsigned NO_KEY = 0xffffffffu;   // a lane that adds nothing
constexpr unsigned FULL = 0xffffffffu;

// Adds one (ox, oy) pair of corners, c0 (oz = 0, contributions a) and c0 + 1
// (oz = 1, b), with float4 atomics: one when c0 is even (the pair fills a
// 16-byte-aligned float4), else two, each padded with zeros, which add
// nothing (the gradient starts at +0 and x + 0 == x). An all-zero float4 is
// not added.
__device__ __forceinline__ void add_pair(float2* grad_table, unsigned c0,
                                         float2 a, float2 b) {
    float4* t4 = reinterpret_cast<float4*>(grad_table) + (c0 >> 1);
    const float4 lo = (c0 & 1) ? make_float4(0.0f, 0.0f, a.x, a.y)
                               : make_float4(a.x, a.y, b.x, b.y);
    if (lo.x != 0.0f || lo.y != 0.0f || lo.z != 0.0f || lo.w != 0.0f)
        atomicAdd(t4, lo);
    if ((c0 & 1) && (b.x != 0.0f || b.y != 0.0f))
        atomicAdd(t4 + 1, make_float4(b.x, b.y, 0.0f, 0.0f));
}

__global__ void __launch_bounds__(THREADS)
brick_bwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                 const float* __restrict__ nz, int n_samples, int rows,
                 const int* __restrict__ levels, int n_levels, int total,
                 const float2* __restrict__ grad_out,
                 float2* __restrict__ grad_table) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    const int lane = threadIdx.x & 31;
    const int n_warps = gridDim.x * (THREADS / 32);
    // a whole warp walks the same bases, so it stays converged for the
    // shuffles
    for (long long base = blockIdx.x * THREADS + threadIdx.x - lane;
         base < total; base += n_warps * 32) {
        const int g = (int)base + lane;
        float2 gg = make_float2(0.0f, 0.0f);
        if (g < total) gg = __ldg(grad_out + g);
        const bool live = gg.x != 0.0f || gg.y != 0.0f;
        BrickCorner c = {};
        unsigned row = 0, key = NO_KEY;
        if (live) {
            int si;
            const int l = point_sample(g, lv, n_levels, n_samples, si);
            c = brick_locate(__ldg(nx + si), __ldg(ny + si), __ldg(nz + si),
                             lv[l * LV], lv[l * LV + 1], lv[l * LV + 2], rows);
            row = (unsigned)l * rows + c.row;
            key = row * 27u + (c.loc[0] * 3 + c.loc[1]) * 3 + c.loc[2];
        }
        // JAX rounds each contribution w * g to bf16 before any sum: v holds
        // the 8 corners' two features in (ox, oy, oz) order
        float v[16];
        int q = 0;
        brick_for_corners(c, [&](int, float w) {
            v[2 * q] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, gg.x)));
            v[2 * q + 1] =
                __bfloat162float(__float2bfloat16_rn(__fmul_rn(w, gg.y)));
            ++q;
        });
        // runs of one voxel along the warp: each run's first lane gets the
        // run's float32 sums (a segmented reduction by shuffles, as many
        // steps as the longest run needs; none when no two neighbours share
        // a voxel)
        const unsigned prev = __shfl_up_sync(FULL, key, 1);
        const bool head = lane == 0 || prev != key;
        const unsigned heads = __ballot_sync(FULL, head);
        if (heads != FULL) {
            const unsigned after = heads & ~((2u << lane) - 1u);
            const int last = after ? __ffs(after) - 2 : 31;
            for (int d = 1; __any_sync(FULL, lane + d <= last); d <<= 1) {
                const bool in = lane + d <= last;
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const float o = __shfl_down_sync(FULL, v[j], d);
                    if (in) v[j] = __fadd_rn(v[j], o);
                }
            }
        }
        if (head && live) {
            const unsigned c0 = row * (ROW / 2)
                                + (c.loc[0] * 4 + c.loc[1]) * 4 + c.loc[2];
#pragma unroll
            for (int p = 0; p < 4; ++p)
                add_pair(grad_table, c0 + (p >> 1) * 16 + (p & 1) * 4,
                         make_float2(v[4 * p], v[4 * p + 1]),
                         make_float2(v[4 * p + 2], v[4 * p + 3]));
        }
    }
}

}  // namespace

extern "C" int brick_encode_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int rows,
        const void* levels, int n_levels, void* out, void* stream) {
    const BrickLevels enc = {(const __nv_bfloat16*)table, rows};
    return launch_ray_tile(brick_ray_fwd_kernel, enc, nx, ny, nz, n_rays,
                           n_samples, per_ray, levels, n_levels, out, stream);
}

extern "C" int brick_encode_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_samples, int rows,
        const void* levels, int n_levels, long long total, const void* grad_out,
        void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (total >= (1LL << 31) || (long long)n_levels * rows * (ROW / 2) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)grad_out & 7) || ((uintptr_t)grad_table & 15))
        return (int)cudaErrorInvalidValue;
    if (total <= 0) return (int)cudaSuccess;
    brick_bwd_kernel<<<plan_grid(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples, rows,
        (const int*)levels, n_levels, (int)total, (const float2*)grad_out,
        (float2*)grad_table);
    return (int)cudaGetLastError();
}
