// ray_points.cuh: the level plan of the ray-structured grid encodes, shared
// by brick_encode.cu and hash_encode.cu, and their forwards' tile encode.
//
// Mirrors level_plan in perf_tpu_torch/kernels/hashgrid.py: one row of
// PLAN_COLS ints per level, (res, lookup size, hashed, stride, points per
// ray, first point). Level l with stride k reads, for each ray, the samples
// 0, k, 2k, ..., S-k and S-1 (npts = S/k + 1), or every sample when k == 1
// (npts = S); its points are numbered from `first`, ray after ray. The
// brick backward walks the plan's points; the forwards and the hash
// backward walk tiles of rays (ray_encode_tile, below; hash_encode.cu).

#pragma once

#include <cuda_runtime.h>

constexpr int PLAN_MAX_LEVELS = 32;
constexpr int PLAN_COLS = 6;

// Copies the plan into shared memory `lv` (PLAN_MAX_LEVELS * PLAN_COLS
// ints); every thread of the block must call it.
__device__ __forceinline__ void load_plan(int* lv, const int* __restrict__ levels,
                                          int n_levels) {
    for (int i = threadIdx.x; i < n_levels * PLAN_COLS; i += blockDim.x)
        lv[i] = levels[i];
    __syncthreads();
}

// Grid size of a grid-stride loop over `total` items of `threads` each.
inline unsigned plan_grid(long long total, int threads) {
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}

// ---------------------------------------------------------------------------
// The forwards' tile encode: coordinates [N, S] -> features [N, S, 2L]
// float32, every level's coarse points encoded and lerped back to the S
// samples (JAX's hash_encode_ray / brick_encode_ray with _lerp_upsample and
// the stack of the levels; the point form is rays of one sample).
//
// A block takes a tile of `tile` rays (about TILE_SAMPLES samples) and
// walks every level for them:
//   1. stage: the tile's coordinates, contiguous in each of nx, ny, nz,
//      go to shared memory in one coalesced pass;
//   2. coarse: every level's coarse points of the tile, numbered level
//      after level and ray after ray inside the tile, are spread evenly
//      over the threads (thread t takes the tile's points t, t + T, ...);
//      each reads its sample's coordinates from shared memory, calls the
//      encoder (Enc: the level's two features at a point) and writes the
//      float2 to shared memory;
//   3. store: each output row of the tile (one sample, 2L floats) is
//      written as L/2 float4s (L even) or L float2s, a level's two values
//      lerped from its coarse points as _lerp_upsample does, left * (1 - w)
//      + right * w with w = j / k, every operation rounded on its own; a
//      stride-1 level is a copy. Neighbouring threads write neighbouring
//      16 bytes of the tile's rows, marked evict-first: the rows (84-134
//      MB at the training shapes) would otherwise push the tables out of
//      the L2 (8% off the brick forward on an H100, tools/encode_probe.py).
// Index arithmetic is 32-bit inside a tile (the tile's base is 64-bit);
// thread t's ray and point (phase 2) and sample (phase 3) advance by
// additions, so no thread searches its level or divides per point (a
// division a level where the thread has points, none a sample).
// Strides are powers of two (hashgrid.level_strides'; the wrappers check).

constexpr int TILE_SAMPLES = 256;   // samples a tile aims at
constexpr int TILE_THREADS = 256;   // at most; a multiple of the chunks a row
// dynamic shared memory a tile may take before it is cut to fewer rays: on
// an H100 the sphere field's point form took 0.44 ms with 36 KB tiles
// against 0.23 with 18 KB ones (tools/encode_probe.py, PERF.md), the other
// shapes the steps run changed by under 10%
constexpr int TILE_SMEM_TARGET = 20 * 1024;
constexpr int TILE_SMEM_MAX = 232448 - 2048;   // the H100's 227 KB, less static

struct TileLevel {
    int res, lookup, hashed;   // the plan's lookup columns (the encoder's)
    int k, lg, npts;           // stride, log2 stride, coarse points a ray
    int off;                   // coarse points a ray of the levels before
    int n, start;              // the tile's points; thread (start + t) % T
                               // takes the level's point t first
    int dr, dp;                // a thread's stride T over the points, in
                               // rays and points
    float inv;                 // 1 / k, exact (k a power of two)
};

struct TileArgs {
    const float* __restrict__ nx;
    const float* __restrict__ ny;
    const float* __restrict__ nz;
    int n_rays, n_samples;
    int tile;       // rays a tile
    int per_ray;    // coarse points a ray, all levels
    const int* __restrict__ levels;   // the level plan, PLAN_COLS a level
    int n_levels;
    float* __restrict__ out;          // [n_rays, n_samples, 2 * n_levels]
};

// Output chunks a row: float4s of two levels, or float2s of one when the
// level count is odd.
__host__ __device__ __forceinline__ int tile_chunks(int n_levels) {
    return (n_levels & 1) ? n_levels : n_levels / 2;
}

// Host: rays a tile (0 when one ray does not fit the shared memory), the
// dynamic shared memory and the threads a block.
inline int tile_shape(int n_samples, int per_ray, int n_levels, int* smem,
                      int* threads) {
    const long long ray_bytes = (2LL * per_ray + 3LL * n_samples) * 4;
    int tile = n_samples >= TILE_SAMPLES ? 1 : TILE_SAMPLES / n_samples;
    while (tile > 1 && tile * ray_bytes > TILE_SMEM_TARGET) tile /= 2;
    if (ray_bytes > TILE_SMEM_MAX) return 0;
    const int c = tile_chunks(n_levels);
    *smem = (int)(tile * ray_bytes);
    *threads = TILE_THREADS / c * c;
    return tile;
}

// Phase 0: the tile's view of the plan for its nr rays (thread l <
// n_levels fills level l).
__device__ __forceinline__ void tile_plan(TileLevel* lv, const TileArgs& a,
                                          int nr, int tid, int threads) {
    if (tid >= a.n_levels) return;
    const int* row = a.levels + tid * PLAN_COLS;
    TileLevel L;
    L.res = row[0];
    L.lookup = row[1];
    L.hashed = row[2];
    L.k = row[3];
    L.lg = __ffs(row[3]) - 1;
    L.npts = row[4];
    L.off = row[5] / a.n_rays;   // first point = n_rays * off
    L.n = nr * L.npts;
    L.start = nr * L.off % threads;
    L.dr = threads / L.npts;
    L.dp = threads - L.dr * L.npts;
    L.inv = __fdiv_rn(1.0f, (float)L.k);
    lv[tid] = L;
}

// Phase 1: the tile's nr rays of coordinates into cs (3 x tile * S floats).
__device__ __forceinline__ void tile_stage(const TileArgs& a, float* cs,
                                           long long base, int nr, int tid,
                                           int threads) {
    const int ns = nr * a.n_samples, cstride = a.tile * a.n_samples;
    for (int i = tid; i < ns; i += threads) {
        cs[i] = __ldg(a.nx + base + i);
        cs[cstride + i] = __ldg(a.ny + base + i);
        cs[2 * cstride + i] = __ldg(a.nz + base + i);
    }
}

// Phase 2: every level's coarse points of the tile into co (level l's at
// co + tile * off_l, ray r's points at r * npts). The tile's points are
// numbered level after level, ray after ray, and dealt to the threads in
// turn, so each thread's share differs by at most one point.
template <class Enc>
__device__ __forceinline__ void tile_coarse(const TileArgs& a, const TileLevel* lv,
                                            const Enc& enc, float2* co,
                                            const float* cs, int tid,
                                            int threads) {
    const int S = a.n_samples, cstride = a.tile * S;
    for (int l = 0; l < a.n_levels; ++l) {
        const TileLevel L = lv[l];
        int t = tid - L.start;
        if (t < 0) t += threads;
        if (t >= L.n) continue;
        int r = t / L.npts, p = t - r * L.npts;
        float2* dst = co + a.tile * L.off;
        for (; t < L.n; t += threads) {
            const int s = L.k == 1 ? p : (p == L.npts - 1 ? S - 1 : p * L.k);
            const int si = r * S + s;
            dst[t] = enc(l, L, cs[si], cs[cstride + si], cs[2 * cstride + si]);
            p += L.dp;
            r += L.dr;
            if (p >= L.npts) {
                p -= L.npts;
                ++r;
            }
        }
    }
}

// Level L's two features at sample s of the tile's ray r, from its coarse
// points: _lerp_upsample's left * (1 - w) + right * w, w = j / k (exactly
// j * (1 / k): k is a power of two).
__device__ __forceinline__ float2 tile_lerp(const float2* co, const TileLevel& L,
                                            int tile, int r, int s) {
    const float2* c = co + tile * L.off + r * L.npts;
    if (L.k == 1) return c[s];
    const int q = s >> L.lg, j = s & (L.k - 1);
    const float2 lo = c[q], hi = c[q + 1];
    const float w = __fmul_rn((float)j, L.inv);
    const float v = __fsub_rn(1.0f, w);
    return make_float2(__fadd_rn(__fmul_rn(lo.x, v), __fmul_rn(hi.x, w)),
                       __fadd_rn(__fmul_rn(lo.y, v), __fmul_rn(hi.y, w)));
}

// Phase 3: the tile's rows, lerped and stored. Thread t keeps its chunk
// c = t % C and walks rows t / C, t / C + T / C, ... (T % C == 0).
__device__ __forceinline__ void tile_store(const TileArgs& a, const TileLevel* lv,
                                           const float2* co, long long base,
                                           int nr, int tid, int threads) {
    const int S = a.n_samples, W = 2 * a.n_levels;
    const int C = tile_chunks(a.n_levels), c = tid % C, step = threads / C;
    const bool quad = 2 * C == a.n_levels;
    const TileLevel A = lv[quad ? 2 * c : c], B = lv[quad ? 2 * c + 1 : c];
    const int ns = nr * S;
    int i = tid / C;
    int r = i / S, s = i - r * S;
    const int dr = step / S, ds = step - dr * S;
    float* row = a.out + base * W;
    for (; i < ns; i += step) {
        const float2 u = tile_lerp(co, A, a.tile, r, s);
        if (quad) {
            const float2 v = tile_lerp(co, B, a.tile, r, s);
            __stcs(reinterpret_cast<float4*>(row + i * W + 4 * c),
                   make_float4(u.x, u.y, v.x, v.y));
        } else {
            __stcs(reinterpret_cast<float2*>(row + i * W + 2 * c), u);
        }
        s += ds;
        r += dr;
        if (s >= S) {
            s -= S;
            ++r;
        }
    }
}

// The block's whole tile; launched with tile_shape's threads and dynamic
// shared memory, one block per `tile` rays.
template <class Enc>
__device__ __forceinline__ void ray_encode_tile(const TileArgs& a, const Enc& enc) {
    __shared__ TileLevel lv[PLAN_MAX_LEVELS];
    extern __shared__ float4 tile_smem[];
    float2* co = reinterpret_cast<float2*>(tile_smem);
    float* cs = reinterpret_cast<float*>(co + a.tile * a.per_ray);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int r0 = blockIdx.x * a.tile;
    const int nr = min(a.tile, a.n_rays - r0);
    const long long base = (long long)r0 * a.n_samples;
    tile_plan(lv, a, nr, tid, threads);
    tile_stage(a, cs, base, nr, tid, threads);
    __syncthreads();
    tile_coarse(a, lv, enc, co, cs, tid, threads);
    __syncthreads();
    tile_store(a, lv, co, base, nr, tid, threads);
}

// Host: launches `kernel` (a __global__ that runs ray_encode_tile with
// `enc`) over tiles of the rays, on `stream`. tile_shape picks the rays a
// tile and the threads a block unless `tile` > 0 gives them (with
// `threads`, a multiple of tile_chunks: the design probe's sweep).
template <class Enc>
int launch_ray_tile(void (*kernel)(TileArgs, Enc), const Enc& enc,
                    const void* nx, const void* ny, const void* nz,
                    int n_rays, int n_samples, int per_ray,
                    const void* levels, int n_levels, void* out,
                    void* stream, int tile = 0, int threads = 0) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (n_rays <= 0 || n_samples <= 0) return (int)cudaSuccess;
    int smem, auto_threads;
    const int auto_tile = tile_shape(n_samples, per_ray, n_levels, &smem,
                                     &auto_threads);
    if (auto_tile == 0) return (int)cudaErrorInvalidValue;
    if (tile <= 0) {
        tile = auto_tile;
        threads = auto_threads;
    } else {
        smem = tile * (2 * per_ray + 3 * n_samples) * 4;
    }
    if (smem > 48 * 1024) {   // past the default: one ray of a long plan
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const TileArgs a = {(const float*)nx, (const float*)ny, (const float*)nz,
                        n_rays, n_samples, tile, per_ray, (const int*)levels,
                        n_levels, (float*)out};
    kernel<<<(n_rays + tile - 1) / tile, threads, smem,
             (cudaStream_t)stream>>>(a, enc);
    return (int)cudaGetLastError();
}
