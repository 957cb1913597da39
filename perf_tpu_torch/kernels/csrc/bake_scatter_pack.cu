// bake_scatter_pack: write evaluated bake corners straight into the packed
// snapshot table, one thread per corner.
//
// Replaces (JAX): perf_tpu/render/snapshot.py _bake_chunk_device's scatter
// into the [(res+1)^3, 4] bf16 volume plus _brick_pack_dense, which slices
// that volume into overlapping 4^3-corner bricks on a stride-3 grid.
//
// Corner (i, j, k) with values (sigma, r, g, b) lies in brick b = i / 3 at
// local corner i % 3 on each axis, and also in brick i / 3 - 1 at local
// corner 3 when i % 3 == 0 and i > 0 (bricks overlap by one corner). So a
// corner lands in up to 2 x 2 x 2 rows of the [nb^3, 256] bf16 table, at
// lane ((cx*4 + cy)*4 + cz)*4 + f, each one aligned 8-byte store of its
// four bf16 values (rounded to nearest even, as JAX's astype). Every
// (row, lane) has exactly one owning corner, so there are no races; rows of
// corners that are not occupied keep the zeros the wrapper allocated.
//
// What bounds it on the H100: 16 bytes read and up to 64 bytes written per
// corner, scattered across rows: memory-bound and small next to field_eval.
// The JAX path's 456 MB intermediate volume is never built.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_pack_kernel(const long long* __restrict__ idx,
                    const float4* __restrict__ vals, long long n, int res,
                    int nb, uint2* __restrict__ table) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const long long rp1 = res + 1;
    long long f = idx[t];
    int c[3] = {(int)(f / (rp1 * rp1)), (int)((f / rp1) % rp1), (int)(f % rp1)};
    float4 v = vals[t];
    __nv_bfloat162 sr = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 gb = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&sr);
    packed.y = *reinterpret_cast<uint32_t*>(&gb);

    int nbr[3], bb[3][2], ll[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        bb[a][0] = c[a] / 3;
        ll[a][0] = c[a] % 3;
        nbr[a] = 1;
        if (ll[a][0] == 0 && c[a] > 0) {
            bb[a][1] = bb[a][0] - 1;
            ll[a][1] = 3;
            nbr[a] = 2;
        }
    }
    for (int x = 0; x < nbr[0]; ++x)
        for (int y = 0; y < nbr[1]; ++y)
            for (int z = 0; z < nbr[2]; ++z) {
                long long row = ((long long)bb[0][x] * nb + bb[1][y]) * nb + bb[2][z];
                int corner = (ll[0][x] * 4 + ll[1][y]) * 4 + ll[2][z];
                table[row * 64 + corner] = packed;
            }
}

}  // namespace

extern "C" int bake_scatter_pack_launch(const void* idx, const void* vals,
                                        long long n, int res, int nb,
                                        void* table, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n + THREADS - 1) / THREADS;
    scatter_pack_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)idx, (const float4*)vals, n, res, nb, (uint2*)table);
    return (int)cudaGetLastError();
}
