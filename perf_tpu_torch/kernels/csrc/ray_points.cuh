// ray_points.cuh: the level plan of the ray-structured grid encodes, shared
// by brick_encode.cu and hash_encode.cu.
//
// Mirrors level_plan in perf_tpu_torch/kernels/hashgrid.py: one row of
// PLAN_COLS ints per level, (res, lookup size, hashed, stride, points per
// ray, first point). Level l with stride k reads, for each ray, the samples
// 0, k, 2k, ..., S-k and S-1 (npts = S/k + 1), or every sample when k == 1
// (npts = S); its points are numbered from `first`, ray after ray.

#pragma once

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

// The level of global point g and the sample it reads: returns the level,
// sets ray and sample.
__device__ __forceinline__ int plan_point(long long g, const int* lv, int n_levels,
                                          int n_samples, long long& ray, int& s) {
    int l = 0;
    while (l + 1 < n_levels && g >= (long long)lv[(l + 1) * PLAN_COLS + 5]) ++l;
    const int k = lv[l * PLAN_COLS + 3], npts = lv[l * PLAN_COLS + 4];
    long long local = g - (long long)lv[l * PLAN_COLS + 5];
    ray = local / npts;
    int p = (int)(local - ray * npts);
    s = (k == 1) ? p : (p == npts - 1 ? n_samples - 1 : p * k);
    return l;
}

// Grid size of a grid-stride loop over `total` items of `threads` each.
inline unsigned plan_grid(long long total, int threads) {
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)blocks;
}
