// hash_encode: the multiresolution hash-grid encode of the ray-structured
// training samples and of points, with linear interpolation (the NGP
// field's) or smoothstep (the sphere field's) as a compile-time variant:
// the forward writes the finished features (hash_encode_fwd_launch,
// hash_encode_smooth_fwd_launch), the backward takes their cotangent and
// writes the table gradient (hash_encode_bwd_launch,
// hash_encode_smooth_bwd_launch).
//
// Replaces (JAX): perf_tpu/kernels/hashgrid.py hash_encode_ray (training:
// encode_level_coords per level at the strides of level_strides, each
// level lerped back to the S samples by _lerp_upsample, the levels
// stacked) and hash_encode_coords (the bake, the occupancy prune, the
// preview, the proposal fields; the sphere field's hash encoding,
// perf_tpu/fields/sphere_field.py:86, with smoothstep: every stride 1, rays
// of one sample), and their autodiff transpose (the table gradient: the
// transpose of the stack, of _lerp_upsample and of encode_level_coords).
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
//
// Backward: the features' cotangent [N, S, 2L] float32 as autograd hands
// it in, the float32 table gradient [L, 2, T] out (JAX's scatter-add of
// the gather's transpose, no bf16 rounding). A block walks tiles of rays:
//   1. stage: the tile's coordinates and its cotangent rows go to shared
//      memory in one coalesced pass each (the cotangent with 16-byte
//      streaming reads: it is read once, and the gradient should keep the
//      L2), the rows padded to 2L + 1 floats, so that lanes on
//      neighbouring samples of one level read distinct banks;
//   2. the tile's coarse points, level after level and ray after ray, are
//      dealt to the lanes in order, 32 consecutive points a warp. A lane
//      forms its point's two cotangents as lerp_levels_transpose does
//      (hashgrid.py): at stride k > 1, left = sum_j g[pk + j] * (1 - w_j)
//      over its own segment and right = sum_j g[(p-1)k + j] * w_j over the
//      one before, w_j = j * (1 / k) (= j / k, k a power of two), the
//      point's cotangent left + right (left alone at the first point,
//      right alone at the last), each operation rounded alone; the lanes
//      start their sums at j = lane mod k (the bank of a segment's j-th
//      sample repeats every k lanes), so the order of a sum's terms is
//      rotated; at stride 1 the cotangent is read as it is;
//   3. a warp whose 32 points all have zero cotangents skips them; else a
//      live lane locates its point's cell (hash_cell.cuh) and forms its 8
//      corners' 16 contributions weight * cotangent;
//   4. neighbouring lanes whose points fall in one cell of one level (the
//      same 8 rows: a ray's coarse samples along it, a point form's
//      neighbouring points) sum their contributions by warp shuffles, as
//      many steps as the warp's longest run needs;
//   5. each run's first lane adds its 8 corners: an 8-byte float2 atomic
//      a corner (sm_90's vector atomics) into an [L, T, 2] accumulator;
//      levels of the wrapper's shared-memory plan (hashgrid.shared_levels:
//      dense levels with many points a row, whose rows fit) add into a
//      block's copy instead, which the block adds to the accumulator once
//      after its last tile; the smoothstep instance adds a dense level's
//      two oz corners, neighbouring rows, with one float4 atomic where they
//      start one (PAIRS).
// The launcher zeroes the accumulator (hash_grad_zero_kernel), launches
// the tiles and turns the accumulator into [L, 2, T] in one pass
// (hash_grad_transpose_kernel). On an H100 (tools/encode_probe.py
// --backward; PERF.md keeps the readings of the designs tried) at the hash
// geometry phase's 8192 x 128 plan: 0.53 ms against 0.95 with two float
// atomics a corner into [L, 2, T] and 0.63 without the runs' sums (the old
// design and PyTorch's transpose: 2.31); passes over fewer levels at a
// time, to keep fewer levels' rows busy in L2, were slower (0.58-0.87).
// Level 0 in shared memory took 4-10% off the point forms (at least 46
// points a row) and added 2% to the ray form (15); float4 pairs took 4%
// off the sphere field's point form and added up to 7% to the proposal
// field's. No position gradient: the wrapper refuses coordinates that
// require one (the sphere field's comes from hash_encode_grad.cu).
//
// What bounds it on the H100: memory, on paper. The default grid's f32
// tables are 2 MiB a level, 32 MiB a head, so one head's table sits in
// the 50 MB L2. The forward reads the coordinates once (12 bytes a
// sample), 8 scattered 8-byte table entries a coarse point (8 L2 sectors,
// by hypothesis its limit: no counter was read), and writes 8L bytes a
// sample (128 at 16 levels), which at the training shapes outweighs the
// coordinates ten to one. The backward reads the same 8L bytes of
// cotangent a sample and writes the 32 MiB gradient once; what holds it,
// as a hypothesis, is the rate at which L2 retires its atomics, 8 a run
// of points in one cell, and those that contend on one row of the coarse
// dense levels (17^3 rows at level 0). Float atomics make its sum order
// change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "hash_cell.cuh"
#include "ray_points.cuh"

namespace {

template <bool SMOOTH>
__global__ void __launch_bounds__(TILE_THREADS)
hash_ray_fwd_kernel(TileArgs a, HashLevels<SMOOTH> enc) {
    ray_encode_tile(a, enc);
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

// ---------------------------------------------------------------------------
// The backward.

constexpr int BWD_THREADS = 256;
// staged bytes (coordinates and cotangent rows) a tile aims at, before the
// shared-memory levels: on an H100 10 and 40 KB tiles were no faster
// (tools/encode_probe.py --backward, PERF.md)
constexpr int BWD_SMEM_TARGET = 20 * 1024;
constexpr unsigned FULL = 0xffffffffu;
// the run key of a lane that adds nothing: NO_KEY ^ lane, its own run
constexpr unsigned long long NO_KEY = ~0ull;

struct BwdArgs {
    TileArgs t;                      // coordinates, plan, tile (out unused)
    const float* __restrict__ grad;  // [n_rays, n_samples, 2 * n_levels]
    float2* __restrict__ acc;        // [L, T, 2], zeroed
    int table_size;
    uint32_t mask;
    unsigned shared_levels;          // bit l: level l summed in shared memory
    int slab_floats;                 // those levels' rows x 2, together
    int n_tiles;                     // tiles of rays
};

// Host: rays a tile (0 when one ray does not fit the shared memory) and the
// dynamic shared memory a block, the shared-memory levels' slab first; a
// ray stages its cotangent rows (2L + 1 floats a sample) and its three
// coordinates a sample.
inline int bwd_tile_shape(int n_samples, int n_levels, int slab_floats,
                          int* smem) {
    const long long ray_bytes = 4LL * n_samples * (2 * n_levels + 1 + 3);
    int tile = n_samples >= TILE_SAMPLES ? 1 : TILE_SAMPLES / n_samples;
    while (tile > 1 && tile * ray_bytes > BWD_SMEM_TARGET) tile /= 2;
    const long long bytes = 4LL * slab_floats + tile * ray_bytes;
    if (bytes > TILE_SMEM_MAX) return 0;
    *smem = (int)bytes;
    return tile;
}

// The tile's n_rows cotangent rows of W floats from g into rows of W + 1
// floats, with streaming reads (each is read once): the rows are one run of
// floats, read 16 bytes a lane after a scalar head up to g's next 16-byte
// boundary, then a scalar tail.
__device__ __forceinline__ void stage_cot(const float* __restrict__ g,
                                          float* cot, int n_rows, int W,
                                          int tid, int threads) {
    // element e of the run goes to e + e / W
    const int count = n_rows * W;
    const int head = min(count,
                         (int)(((16u - ((uintptr_t)g & 15u)) & 15u) >> 2));
    for (int e = tid; e < head; e += threads) cot[e + e / W] = __ldcs(g + e);
    const int n4 = (count - head) >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g + head);
    for (int q = tid; q < n4; q += threads) {
        const float4 v = __ldcs(g4 + q);
        const int e = head + 4 * q;
        int row = e / W, col = e - row * W;
        float* d = cot + row * (W + 1);
        const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            d[col] = vals[j];
            if (++col == W) {
                col = 0;
                d += W + 1;
            }
        }
    }
    for (int e = head + 4 * n4 + tid; e < count; e += threads)
        cot[e + e / W] = __ldcs(g + e);
}

// The two cotangents of coarse point p of ray r at level L (stride L.k),
// from the staged rows (ray r's at cot + r * S * RS, the level's pair at
// col): the transpose of _lerp_upsample and of the stack, as
// lerp_levels_transpose forms it; each lane starts its sums at j = rot,
// the sums of its own segment (left) and the one before (right) side by
// side.
__device__ __forceinline__ float2 coarse_cot(const float* cot,
                                             const TileLevel& L, int col,
                                             int r, int p, int S, int RS,
                                             int rot) {
    const float* row = cot + r * S * RS + col;
    if (L.k == 1) return make_float2(row[p * RS], row[p * RS + 1]);
    const int k = L.k;
    const bool left = p < L.npts - 1, right = p > 0;
    // left: this segment, weights 1 - w; right: the one before, weights w
    const float* ql = row + p * k * RS;
    const float* qr = ql - k * RS;
    float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    for (int jj = 0; jj < k; ++jj) {
        const int j = (jj + rot) & (k - 1);
        const float w = __fmul_rn((float)j, L.inv);
        if (left) {
            const float v = __fsub_rn(1.0f, w);
            a0 = __fadd_rn(a0, __fmul_rn(ql[j * RS], v));
            a1 = __fadd_rn(a1, __fmul_rn(ql[j * RS + 1], v));
        }
        if (right) {
            b0 = __fadd_rn(b0, __fmul_rn(qr[j * RS], w));
            b1 = __fadd_rn(b1, __fmul_rn(qr[j * RS + 1], w));
        }
    }
    if (!right) return make_float2(a0, a1);
    return make_float2(__fadd_rn(a0, b0), __fadd_rn(a1, b1));
}

// Adds one corner's two contributions at row of level l: one 8-byte float2
// atomic.
__device__ __forceinline__ void add_corner(float2* acc, int table_size, int l,
                                           uint32_t row, float g0, float g1) {
    if (g0 == 0.0f && g1 == 0.0f) return;
    atomicAdd(acc + (size_t)l * table_size + row, make_float2(g0, g1));
}

// Phases 2-5 for the tile's nr rays.
template <bool SMOOTH, bool PAIRS>
__device__ __forceinline__ void scatter_tile(const BwdArgs& a,
                                             const TileLevel* lv,
                                             const float* cot, const float* cs,
                                             float* slab, const int* slab_at,
                                             int nr, int tid, int threads) {
    const int lane = tid & 31;
    const int S = a.t.n_samples, n_levels = a.t.n_levels;
    const int RS = 2 * n_levels + 1;
    const int cstride = a.t.tile * S;
    const int n_pts = nr * a.t.per_ray;
    int l = 0;   // the level of the lane's point; its points only grow
    // a warp walks 32 consecutive points; the bound is the warp's own, so
    // the warp stays converged for its ballots and shuffles
    for (int i0 = tid - lane; i0 < n_pts; i0 += threads) {
        const int i = i0 + lane;
        float2 c = make_float2(0.0f, 0.0f);
        float p3[3] = {0.0f, 0.0f, 0.0f};
        if (i < n_pts) {
            while (l + 1 < n_levels && i >= nr * lv[l + 1].off) ++l;
            const TileLevel& L = lv[l];
            const int j = i - nr * L.off;
            const int r = j / L.npts, p = j - r * L.npts;
            c = coarse_cot(cot, L, 2 * l, r, p, S, RS, lane);
            const int s = L.k == 1 ? p : (p == L.npts - 1 ? S - 1 : p * L.k);
            const int si = r * S + s;
            p3[0] = cs[si];
            p3[1] = cs[cstride + si];
            p3[2] = cs[2 * cstride + si];
        }
        const bool live = c.x != 0.0f || c.y != 0.0f;   // else adds zeros
        if (!__any_sync(FULL, live)) continue;
        HashCell h = {};
        float v[16];
        unsigned long long key = NO_KEY ^ lane;
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = 0.0f;
        if (live) {
            const TileLevel& L = lv[l];
            h = hash_cell<SMOOTH, false>(p3, L.res);
            int q = 0;
            for_hash_corners<false>(h, L.lookup, L.hashed, a.mask,
                                    [&](uint32_t, float w) {
                v[2 * q] = __fmul_rn(c.x, w);
                v[2 * q + 1] = __fmul_rn(c.y, w);
                ++q;
            });
            key = ((unsigned long long)l << 57)
                  | ((unsigned long long)(unsigned)h.c[0] << 38)
                  | ((unsigned long long)(unsigned)h.c[1] << 19)
                  | (unsigned long long)(unsigned)h.c[2];
        }
        // runs of one cell along the warp: each run's first lane gets the
        // run's sums (a segmented reduction by shuffles, as many steps as
        // the longest run needs; none when no two neighbours share a cell)
        const unsigned long long prev = __shfl_up_sync(FULL, key, 1);
        const bool head = lane == 0 || prev != key;
        const unsigned heads = __ballot_sync(FULL, head);
        if (heads != FULL) {
            const unsigned after = heads & ~((2u << lane) - 1u);
            const int last = after ? __ffs(after) - 2 : 31;
            for (int d = 1; __any_sync(FULL, lane + d <= last); d <<= 1) {
                const bool in = lane + d <= last;
#pragma unroll
                for (int q = 0; q < 16; ++q) {
                    const float o = __shfl_down_sync(FULL, v[q], d);
                    if (in) v[q] = __fadd_rn(v[q], o);
                }
            }
        }
        if (!(head && live)) continue;
        const TileLevel& L = lv[l];
        uint32_t rows[8];
        int q = 0;
        for_hash_corners<false>(h, L.lookup, L.hashed, a.mask,
                                [&](uint32_t row, float) { rows[q++] = row; });
        if ((a.shared_levels >> l) & 1u) {
            float* sl = slab + slab_at[l];
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                if (v[2 * m] != 0.0f) atomicAdd(sl + 2 * rows[m], v[2 * m]);
                if (v[2 * m + 1] != 0.0f)
                    atomicAdd(sl + 2 * rows[m] + 1, v[2 * m + 1]);
            }
            continue;
        }
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
            // a dense level's oz = 0, 1 corners are neighbouring rows: one
            // 16-byte atomic when the pair starts a float4 (PAIRS)
            if (PAIRS && !L.hashed && !(rows[m] & 1u)) {
                const float4 pr = make_float4(v[2 * m], v[2 * m + 1],
                                              v[2 * m + 2], v[2 * m + 3]);
                if (pr.x != 0.0f || pr.y != 0.0f || pr.z != 0.0f ||
                    pr.w != 0.0f)
                    atomicAdd(reinterpret_cast<float4*>(
                        a.acc + (size_t)l * a.table_size + rows[m]), pr);
                continue;
            }
            add_corner(a.acc, a.table_size, l, rows[m], v[2 * m],
                       v[2 * m + 1]);
            add_corner(a.acc, a.table_size, l, rows[m + 1], v[2 * m + 2],
                       v[2 * m + 3]);
        }
    }
}

template <bool SMOOTH, bool PAIRS>
__global__ void __launch_bounds__(BWD_THREADS)
hash_ray_bwd_kernel(BwdArgs a) {
    __shared__ TileLevel lv[PLAN_MAX_LEVELS];
    __shared__ int slab_at[PLAN_MAX_LEVELS];
    extern __shared__ float4 bwd_smem[];
    float* slab = reinterpret_cast<float*>(bwd_smem);
    float* cot = slab + a.slab_floats;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int S = a.t.n_samples, W = 2 * a.t.n_levels;
    float* cs = cot + a.t.tile * S * (W + 1);
    if (tid == 0) {   // the slab's levels in order, as the wrapper sized it
        int at = 0;
        for (int l = 0; l < a.t.n_levels; ++l) {
            slab_at[l] = at;
            if ((a.shared_levels >> l) & 1u) {
                const int r1 = a.t.levels[l * PLAN_COLS + 1];
                at += 2 * r1 * r1 * r1;
            }
        }
    }
    for (int i = tid; i < a.slab_floats; i += threads) slab[i] = 0.0f;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int r0 = tile * a.t.tile;
        const int nr = min(a.t.tile, a.t.n_rays - r0);
        const long long base = (long long)r0 * S;
        __syncthreads();   // the previous tile's reads are done
        tile_plan(lv, a.t, nr, tid, threads);
        tile_stage(a.t, cs, base, nr, tid, threads);
        stage_cot(a.grad + base * W, cot, nr * S, W, tid, threads);
        __syncthreads();
        scatter_tile<SMOOTH, PAIRS>(a, lv, cot, cs, slab, slab_at, nr, tid,
                                    threads);
    }
    if (a.shared_levels == 0u) return;
    __syncthreads();
    for (int l = 0; l < a.t.n_levels; ++l) {
        if (!((a.shared_levels >> l) & 1u)) continue;
        const int r1 = a.t.levels[l * PLAN_COLS + 1];
        const float* sl = slab + slab_at[l];
        for (int row = tid; row < r1 * r1 * r1; row += threads)
            add_corner(a.acc, a.table_size, l, (uint32_t)row, sl[2 * row],
                       sl[2 * row + 1]);
    }
}

// The accumulator's fill: 16-byte stores.
__global__ void __launch_bounds__(256)
hash_grad_zero_kernel(float4* __restrict__ acc, long long quads) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < quads; i += (long long)gridDim.x * blockDim.x)
        acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The accumulator [L, T, 2] -> the gradient [L, 2, T]: four rows a thread,
// two 16-byte reads and a 16-byte write to each feature's plane (T a power
// of two >= 4).
__global__ void __launch_bounds__(256)
hash_grad_transpose_kernel(const float4* __restrict__ acc,
                           float4* __restrict__ out, int log2_size,
                           long long quads) {
    const long long per_level = 1LL << (log2_size - 2);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < quads; i += (long long)gridDim.x * blockDim.x) {
        const float4 a = __ldcs(acc + 2 * i), b = __ldcs(acc + 2 * i + 1);
        const long long l = i >> (log2_size - 2), t = i - l * per_level;
        out[2 * l * per_level + t] = make_float4(a.x, a.z, b.x, b.z);
        out[(2 * l + 1) * per_level + t] = make_float4(a.y, a.w, b.y, b.w);
    }
}

// Host: the blocks of the backward kernel that fit an SM at smem bytes of
// dynamic shared memory, and the device's SMs, asked once per kernel,
// device and shared-memory size (a few a process: the plans are few).
template <bool SMOOTH, bool PAIRS>
cudaError_t bwd_grid_limit(int smem, int* blocks) {
    struct Entry { int dev, smem, blocks; };
    static Entry cache[16];
    static int n_cached = 0;
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < n_cached; ++i) {
        if (cache[i].dev == dev && cache[i].smem == smem) {
            *blocks = cache[i].blocks;
            return cudaSuccess;
        }
    }
    auto kernel = hash_ray_bwd_kernel<SMOOTH, PAIRS>;
    if (smem > 48 * 1024) {   // the most any plan takes (bwd_tile_shape)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TILE_SMEM_MAX);
        if (err != cudaSuccess) return err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        BWD_THREADS, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *blocks = std::max(per_sm, 1) * sms;
    if (n_cached < 16) cache[n_cached++] = {dev, smem, *blocks};
    return cudaSuccess;
}

// Host: the backward. scratch: the [L, T, 2] accumulator (16-byte
// aligned); out: the [L, 2, T] gradient, every element written.
template <bool SMOOTH, bool PAIRS>
int bwd_run(const void* nx, const void* ny, const void* nz, int n_rays,
            int n_samples, int per_ray, int table_size, const void* levels,
            int n_levels, const void* grad, unsigned shared_levels,
            int slab_floats, void* scratch, void* out, void* stream) {
    if (n_levels < 1 || n_levels > PLAN_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (table_size < 4 || (table_size & (table_size - 1)))
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)grad & 3) || ((uintptr_t)scratch & 15) || ((uintptr_t)out & 15))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const long long quads = (long long)n_levels * table_size / 4;
    hash_grad_zero_kernel<<<plan_grid(2 * quads, 256), 256, 0, st>>>(
        (float4*)scratch, 2 * quads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_rays > 0 && n_samples > 0) {
        int smem, limit;
        const int tile = bwd_tile_shape(n_samples, n_levels, slab_floats,
                                        &smem);
        if (tile == 0) return (int)cudaErrorInvalidValue;
        err = bwd_grid_limit<SMOOTH, PAIRS>(smem, &limit);
        if (err != cudaSuccess) return (int)err;
        const int n_tiles = (n_rays + tile - 1) / tile;
        const TileArgs t = {(const float*)nx, (const float*)ny, (const float*)nz,
                            n_rays, n_samples, tile, per_ray,
                            (const int*)levels, n_levels, nullptr};
        const BwdArgs a = {t, (const float*)grad, (float2*)scratch,
                           table_size, (uint32_t)table_size - 1u,
                           shared_levels, slab_floats, n_tiles};
        hash_ray_bwd_kernel<SMOOTH, PAIRS>
            <<<std::min(n_tiles, limit), BWD_THREADS, smem, st>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    hash_grad_transpose_kernel<<<plan_grid(quads, 256), 256, 0, st>>>(
        (const float4*)scratch, (float4*)out, __builtin_ctz(table_size),
        quads);
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
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, int table_size, const void* levels,
        int n_levels, const void* grad, int shared_levels, int slab_floats,
        void* scratch, void* out, void* stream) {
    return bwd_run<false, false>(
        nx, ny, nz, n_rays, n_samples, per_ray, table_size, levels, n_levels,
        grad, (unsigned)shared_levels, slab_floats, scratch, out, stream);
}

extern "C" int hash_encode_smooth_bwd_launch(
        const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, int table_size, const void* levels,
        int n_levels, const void* grad, int shared_levels, int slab_floats,
        void* scratch, void* out, void* stream) {
    return bwd_run<true, true>(
        nx, ny, nz, n_rays, n_samples, per_ray, table_size, levels, n_levels,
        grad, (unsigned)shared_levels, slab_floats, scratch, out, stream);
}
