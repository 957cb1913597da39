// occ_grid: the binary occupancy grid of the supervision pool's surface
// points, one thread per (point, offset).
//
// Replaces (JAX): perf_tpu/render/occgrid.py occ_grid_from_points (the
// scatter-max of SupInfoPool.gen_occ_grid): each point, shifted by each of
// the (2 * dilation + 1)^3 world-space offsets of +-dilation / res, is
// quantised as trunc((clip(p + off, -0.999, 0.999) * 0.5 + 0.5) * res) and
// its voxel is set to 1.
//
// What bounds it on the H100: memory. Per point 12 bytes in and 27 one-byte
// scattered stores into a zeroed 16 MB grid (256^3) that stays in L2; every
// store writes the same value, so racing stores need no atomics.
//
// Bitwise parity: each float operation uses a rounding intrinsic in the
// reference's order (no FMA contraction), and the file is compiled with
// -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
occ_kernel(const float* __restrict__ pts, long long n,
           const float* __restrict__ offsets, int n_off, int res,
           uint8_t* __restrict__ grid) {
    const long long total = n * n_off;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < total; g += (long long)gridDim.x * blockDim.x) {
        const long long i = g / n_off;
        const int k = (int)(g - i * n_off);
        long long v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float x = __fadd_rn(pts[3 * i + a], offsets[3 * k + a]);
            x = fminf(fmaxf(x, -0.999f), 0.999f);
            v[a] = (long long)(int)__fmul_rn(__fadd_rn(__fmul_rn(x, 0.5f), 0.5f),
                                             (float)res);
        }
        grid[(v[0] * res + v[1]) * res + v[2]] = 1;
    }
}

}  // namespace

extern "C" int occ_grid_launch(const void* pts, long long n, const void* offsets,
                               int n_off, int res, void* grid, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n * n_off + THREADS - 1) / THREADS;
    if (blocks > 132 * 64) blocks = 132 * 64;
    occ_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)pts, n, (const float*)offsets, n_off, res, (uint8_t*)grid);
    return (int)cudaGetLastError();
}
