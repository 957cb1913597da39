// brick_encode: the ray-structured brick-grid encode of the training path,
// forward (ray_points.cuh's tile encode: the finished [N, S, 2L] features)
// and backward (one warp per 32 consecutive coarse points); and its
// run-dedup form (K12), forward and backward, at the end of this file.
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

// ---------------------------------------------------------------------------
// The run-dedup encode (K12), forward and backward.
//
// Replaces (JAX): perf_tpu/kernels/brickgrid.py brick_encode_ray_dedup with
// encode_brick_level_dedup and corner_interp_dedup's custom VJP (_cid_fwd /
// _cid_bwd). A level with run cap kr (caps[l], 0 = the standard encode above)
// numbers the row changes along each ray's coarse points: a point's run id is
// the count of row changes before it (rows hashed where the level hashes,
// as the encode reads them), clipped at kr - 1. Every point reads the row of
// the first point of its clipped run: its own row while its run id is below
// kr - 1, else the row R* of run kr - 1, which every point past the
// (kr - 1)-th row change reads at its own cell and fractions (wrong data by
// design when a ray has more runs than its cap; the cap is probed with slack).
// JAX gathers one bf16 row per run and expands it back with a one-hot
// product; a one-hot product of bf16 values summed in float32 is the bf16
// value, so a point's features are brick_interp's at the row it reads, and
// equal the standard encode's bitwise where the cap covers every run.
//
// The run ids need a scan along each ray. A warp takes one (ray, level) and
// walks its points 32 at a time (RunScan): each lane locates its point, a
// shuffle gives the previous point's row, a ballot and a popcount give the
// run ids, a second ballot finds the first point of run kr - 1 (R*), and the
// last lane's row and run id carry to the next 32.
//
// Forward: ray_points.cuh's tile encode; the dedup levels' coarse points are
// encoded by tile_runs (a warp per ray and dedup level of the tile, after the
// coordinates are staged) and the other levels by tile_coarse, then every
// level is lerped and stored as the standard forward does. Same bound as the
// standard forward (memory: the rows written); the scan is a few operations
// a point.
//
// Backward (_cid_bwd): each point's contribution w * g of a corner and
// feature is rounded to bf16; a run's contributions are summed in float32,
// and the sum is rounded to bf16 again before it is added in float32 to row
// R (the run's row) of the table gradient. A level with cap 0 keeps the
// standard rule (each contribution rounded once, then float32 sums). The
// kernel runs every level of the call: a warp per (ray, level) walks the
// points in t order and keeps, per lane, the float32 sums of 2 corners x 2
// features of the open run's 128-lane row (lane j: corners 2j, 2j + 1);
// where the run ends (a clipped run ends with the ray), each lane adds its
// four sums (rounded again on a dedup level) with one float4 atomic: one
// atomic a lane a run, against K1's backward's 4-6 a voxel run. A run's sums
// are taken point after point, in the order of the plain version's
// index_add_, so only the atomics across rays change the order of additions
// from run to run. What bounds it: the coordinates, cotangents and table
// gradient are 0.03-0.05 ms of bytes at the training shapes; the warp walks
// its points one after the other (7 shuffles and ~20 operations a point), so
// a (ray, level) of 80 points is 80 steps of one warp.

#include <climits>

namespace {

// The run scan of one (ray, level), 32 points a step, by a whole warp.
struct RunScan {
    int lim;                 // kr - 1: the last run id; INT_MAX without a cap
    unsigned carry_row = 0;  // the previous step's last row
    int carry_cnt = -1;      // its run id
    bool have = false;       // the first point of run lim was seen
    unsigned star = 0;       // its row, R*

    // Lane's point (valid; first: the ray's point 0) has row `row`: sets
    // its run id (cnt, unclipped) and whether a row change starts at it, and
    // returns the row it reads.
    __device__ __forceinline__ unsigned step(bool valid, bool first,
                                             unsigned row, int lane, int& cnt,
                                             bool& change) {
        unsigned prev = __shfl_up_sync(FULL, row, 1);
        if (lane == 0) prev = carry_row;
        change = valid && (first || row != prev);
        const unsigned m = __ballot_sync(FULL, change);
        cnt = carry_cnt + __popc(m & (FULL >> (31 - lane)));
        if (!have) {
            const unsigned h = __ballot_sync(FULL, valid && cnt >= lim);
            if (h) {
                star = __shfl_sync(FULL, row, __ffs(h) - 1);
                have = true;
            }
        }
        carry_row = __shfl_sync(FULL, row, 31);
        carry_cnt = __shfl_sync(FULL, cnt, 31);
        return cnt >= lim ? star : row;
    }
};

struct DedupArgs {
    BrickLevels enc;
    const int* __restrict__ caps;   // [L]: a level's run cap, 0 = standard
};

// The dedup levels' coarse points of the tile into co, as tile_coarse
// writes them: a warp per (level, ray). A last warp of fewer than 32
// threads (an odd level count's block) sits out.
__device__ __forceinline__ void tile_runs(const TileArgs& a, const TileLevel* lv,
                                          const int* caps, const BrickLevels& enc,
                                          float2* co, const float* cs, int nr,
                                          int tid, int threads) {
    const int warps = threads >> 5, warp = tid >> 5, lane = tid & 31;
    if (warp >= warps) return;
    const int S = a.n_samples, cstride = a.tile * S;
    for (int job = warp; job < nr * a.n_levels; job += warps) {
        const int l = job / nr, r = job - l * nr;
        if (!caps[l]) continue;
        const TileLevel L = lv[l];
        float2* dst = co + a.tile * L.off + r * L.npts;
        RunScan scan;
        scan.lim = caps[l] - 1;
        for (int b = 0; b < L.npts; b += 32) {
            const int p = b + lane;
            const bool valid = p < L.npts;
            BrickCorner c = {};
            if (valid) {
                const int s = L.k == 1 ? p : (p == L.npts - 1 ? S - 1 : p * L.k);
                const int si = r * S + s;
                c = brick_locate(cs[si], cs[cstride + si], cs[2 * cstride + si],
                                 L.res, L.lookup, L.hashed, enc.rows);
            }
            int cnt;
            bool change;
            const unsigned row = scan.step(valid, p == 0, c.row, lane, cnt, change);
            if (valid) {
                c.row = row;
                dst[p] = enc.interp(l, c);
            }
        }
    }
}

__global__ void __launch_bounds__(TILE_THREADS)
brick_dedup_fwd_kernel(TileArgs a, DedupArgs d) {
    __shared__ TileLevel lv[PLAN_MAX_LEVELS];
    __shared__ int caps[PLAN_MAX_LEVELS];
    extern __shared__ float4 tile_smem[];
    float2* co = reinterpret_cast<float2*>(tile_smem);
    float* cs = reinterpret_cast<float*>(co + a.tile * a.per_ray);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int r0 = blockIdx.x * a.tile;
    const int nr = min(a.tile, a.n_rays - r0);
    const long long base = (long long)r0 * a.n_samples;
    tile_plan(lv, a, nr, tid, threads);
    if (tid < a.n_levels) {
        caps[tid] = d.caps[tid];
        if (caps[tid]) lv[tid].n = 0;   // tile_coarse leaves the level to tile_runs
    }
    tile_stage(a, cs, base, nr, tid, threads);
    __syncthreads();
    tile_runs(a, lv, caps, d.enc, co, cs, nr, tid, threads);
    tile_coarse(a, lv, d.enc, co, cs, tid, threads);
    __syncthreads();
    tile_store(a, lv, co, base, nr, tid, threads);
}

// Adds lane's four sums of the run ending here to row `row` of level l
// (rounded to bf16 first on a dedup level) and clears them; an all-zero
// float4 is not added.
__device__ __forceinline__ void flush_run(float* grad_table, int l, int rows,
                                          unsigned row, int lane, float* acc,
                                          bool twice) {
    float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (twice) {
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
        v.z = bf16_round(v.z);
        v.w = bf16_round(v.w);
    }
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(grad_table + ((size_t)l * rows + row) * ROW)
                      + lane, v);
    acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
}

__global__ void __launch_bounds__(THREADS)
brick_dedup_bwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                       const float* __restrict__ nz, int n_rays, int n_samples,
                       int rows, const int* __restrict__ levels,
                       const int* __restrict__ caps_in, int n_levels,
                       const float2* __restrict__ grad_out,
                       float* __restrict__ grad_table) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    __shared__ int caps[PLAN_MAX_LEVELS];
    for (int i = threadIdx.x; i < n_levels; i += blockDim.x) caps[i] = caps_in[i];
    load_plan(lv, levels, n_levels);
    const int lane = threadIdx.x & 31;
    // lane j holds corners 2j and 2j + 1 (cz, cz + 1) of the run's row
    const int cx = lane >> 3, cy = (lane >> 1) & 3, cz = 2 * (lane & 1);
    const long long jobs = (long long)n_rays * n_levels;
    const long long n_warps = (long long)gridDim.x * (THREADS / 32);
    for (long long job = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
         job < jobs; job += n_warps) {
        const int r = (int)(job / n_levels), l = (int)(job - (long long)r * n_levels);
        const int* L = lv + l * LV;
        const int res = L[0], nb = L[1], hashed = L[2], k = L[3], npts = L[4];
        const bool twice = caps[l] != 0;
        RunScan scan;
        scan.lim = twice ? caps[l] - 1 : INT_MAX;
        const long long s0 = (long long)r * n_samples;
        const float2* g = grad_out + L[5] + (long long)r * npts;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        unsigned target = 0;
        bool open = false;
        for (int b = 0; b < npts; b += 32) {
            const int p = b + lane;
            const bool valid = p < npts;
            BrickCorner c = {};
            float2 gg = make_float2(0.0f, 0.0f);
            if (valid) {
                const int s = k == 1 ? p : (p == npts - 1 ? n_samples - 1 : p * k);
                c = brick_locate(__ldg(nx + s0 + s), __ldg(ny + s0 + s),
                                 __ldg(nz + s0 + s), res, nb, hashed, rows);
                gg = __ldg(g + p);
            }
            int cnt;
            bool change;
            const unsigned tgt = scan.step(valid, p == 0, c.row, lane, cnt, change);
            // the points that open a run: a row change, up to run lim
            const unsigned starts = __ballot_sync(FULL, change && cnt <= scan.lim);
            const int cell = c.loc[0] | c.loc[1] << 2 | c.loc[2] << 4;
            const int n_in = min(32, npts - b);
            for (int i = 0; i < n_in; ++i) {
                const unsigned ti = __shfl_sync(FULL, tgt, i);
                const int ci = __shfl_sync(FULL, cell, i);
                const float f0 = __shfl_sync(FULL, c.fr[0], i);
                const float f1 = __shfl_sync(FULL, c.fr[1], i);
                const float f2 = __shfl_sync(FULL, c.fr[2], i);
                const float g0 = __shfl_sync(FULL, gg.x, i);
                const float g1 = __shfl_sync(FULL, gg.y, i);
                if ((starts >> i) & 1u) {
                    if (open) flush_run(grad_table, l, rows, target, lane, acc, twice);
                    open = true;
                    target = ti;
                }
                // JAX's contribution of a corner: bf16(((wx * wy) * wz) * g)
                const int ox = cx - (ci & 3), oy = cy - ((ci >> 2) & 3);
                if ((unsigned)ox <= 1u && (unsigned)oy <= 1u) {
                    const float wxy = __fmul_rn(ox ? f0 : __fsub_rn(1.0f, f0),
                                                oy ? f1 : __fsub_rn(1.0f, f1));
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int oz = cz + q - (ci >> 4);
                        if ((unsigned)oz <= 1u) {
                            const float w = __fmul_rn(wxy, oz ? f2 : __fsub_rn(1.0f, f2));
                            acc[2 * q] = __fadd_rn(acc[2 * q],
                                                   bf16_round(__fmul_rn(w, g0)));
                            acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1],
                                                       bf16_round(__fmul_rn(w, g1)));
                        }
                    }
                }
            }
        }
        if (open) flush_run(grad_table, l, rows, target, lane, acc, twice);
    }
}

}  // namespace

extern "C" int brick_encode_dedup_fwd_launch(
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int rows,
        const void* levels, const void* caps, int n_levels, void* out,
        void* stream) {
    const DedupArgs d = {{(const __nv_bfloat16*)table, rows}, (const int*)caps};
    return launch_ray_tile(brick_dedup_fwd_kernel, d, nx, ny, nz, n_rays,
                           n_samples, per_ray, levels, n_levels, out, stream);
}

extern "C" int brick_encode_dedup_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int rows, const void* levels, const void* caps,
        int n_levels, const void* grad_out, void* grad_table, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)grad_out & 7) || ((uintptr_t)grad_table & 15))
        return (int)cudaErrorInvalidValue;
    if (n_rays <= 0 || n_samples <= 0) return (int)cudaSuccess;
    const long long jobs = (long long)n_rays * n_levels;
    brick_dedup_bwd_kernel<<<plan_grid(jobs * 32, THREADS), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_rays, n_samples,
        rows, (const int*)levels, (const int*)caps, n_levels,
        (const float2*)grad_out, (float*)grad_table);
    return (int)cudaGetLastError();
}
