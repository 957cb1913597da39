// row_gather: the two row gathers of the Pallas encode microbenchmark,
// out[i] = table[rows[i]] for a bf16 table [R, 128] and int32 rows [n].
//
// Replaces (JAX): tools/bench_pallas_encode.py take_gather (take_kernel)
// and onehot_gather (onehot_kernel). On the TPU both pin the whole 1 MiB
// table in VMEM and walk a grid of n / block steps; `block` becomes here
// the number of output rows one CTA writes (n must be a multiple of it; the
// wrapper refuses other n, where the JAX grid leaves the tail unwritten).
// An H100 block has at most 227 KB of shared memory, so the table stays in
// device memory and is served from the 50 MB L2.
//
// take: each 256-byte row is copied by 16 lanes with 16-byte loads and
// stores, neighbouring lanes on neighbouring addresses; a CTA of 512
// threads moves 32 rows at a time. Bound: n * (4 + 256) bytes plus the
// table once, over the HBM rate (about 0.041 ms at n = 2^19).
//
// onehot: keeps what the TPU kernel measures, a gather done on the matrix
// unit. Per tile of 128 output rows the CTA streams the table through
// shared memory in K-tiles of 64 rows x 128 (16 KB, rows padded against
// bank conflicts), builds the one-hot A
// tile [128, 64] (bf16 1 where rows[m] == k0 + k) and multiplies it on the
// tensor cores (nvcuda::wmma m16n16k16, bf16 in, f32 sums; warp w owns rows
// 16w..16w+15 and all 128 columns), then rounds the sums to bf16. Every
// output has exactly one non-zero product, so the result is bitwise
// table[rows]. Its own work is 2 * n * R * 128 multiply-adds (5.5e11 FLOP
// at n = 2^19, about 0.56 ms at 989 TFLOP/s), 13.6x the gather's bound:
// this formulation cannot reach the function's bound. A first version: no
// cp.async / TMA double buffering of the K-tiles, no wgmma.
//
// Rows outside [0, R) give zero rows in both kernels (no out-of-bounds
// read); the plain versions refuse them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int W = 128;                 // bf16 per row
constexpr int ROW_VEC = W / 8;         // 16-byte vectors per row
constexpr int TAKE_THREADS = 512;
constexpr int OH_M = 128;              // output rows per tensor-core tile
constexpr int OH_K = 64;               // table rows per K-tile
constexpr int OH_THREADS = 256;        // 8 warps x 16 rows
// shared-memory row strides, padded by 16 bytes so that the 8 rows one
// fragment load reads fall on different banks (unpadded, the 128- and
// 256-byte strides put all 8 on the same 4 banks)
constexpr int A_LD = OH_K + 8;
constexpr int B_LD = W + 8;

__global__ void __launch_bounds__(TAKE_THREADS)
take_kernel(const uint4* __restrict__ table, int n_table_rows,
            const int* __restrict__ rows, int block, uint4* __restrict__ out) {
    const long long r0 = (long long)blockIdx.x * block;
    const int lane = threadIdx.x % ROW_VEC;
    for (int i = threadIdx.x / ROW_VEC; i < block; i += TAKE_THREADS / ROW_VEC) {
        const long long r = r0 + i;
        const int src = rows[r];
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if ((unsigned)src < (unsigned)n_table_rows)
            v = __ldg(table + (size_t)src * ROW_VEC + lane);
        out[r * ROW_VEC + lane] = v;
    }
}

__global__ void __launch_bounds__(OH_THREADS)
onehot_kernel(const __nv_bfloat16* __restrict__ table, int n_table_rows,
              const int* __restrict__ rows, int block,
              __nv_bfloat16* __restrict__ out) {
    using namespace nvcuda;
    __shared__ __align__(128) __nv_bfloat16 a_s[OH_M * A_LD];     // 18 KB
    __shared__ __align__(128) __nv_bfloat16 b_s[OH_K * B_LD];     // 17 KB
    __shared__ __align__(128) float c_s[OH_THREADS / 32][16 * 16]; // 8 KB
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < OH_M * A_LD / 8; i += OH_THREADS)
        reinterpret_cast<uint4*>(a_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    const long long first = (long long)blockIdx.x * block;
    for (long long m0 = first; m0 < first + block; m0 += OH_M) {
        const int my_row = threadIdx.x < OH_M ? rows[m0 + threadIdx.x] : -1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[W / 16];
#pragma unroll
        for (int j = 0; j < W / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
        for (int k0 = 0; k0 < n_table_rows; k0 += OH_K) {
            __syncthreads();   // A cleared and B consumed by every warp
            const uint4* src = reinterpret_cast<const uint4*>(table + (size_t)k0 * W);
            for (int i = threadIdx.x; i < OH_K * ROW_VEC; i += OH_THREADS)
                *reinterpret_cast<uint4*>(b_s + (i / ROW_VEC) * B_LD + (i % ROW_VEC) * 8) =
                    __ldg(src + i);
            const int hit = (my_row >= k0 && my_row < k0 + OH_K) ? my_row - k0 : -1;
            if (hit >= 0) a_s[threadIdx.x * A_LD + hit] = one;
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < OH_K; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> a;
                wmma::load_matrix_sync(a, a_s + warp * 16 * A_LD + kk, A_LD);
#pragma unroll
                for (int j = 0; j < W / 16; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                   wmma::row_major> b;
                    wmma::load_matrix_sync(b, b_s + kk * B_LD + j * 16, B_LD);
                    wmma::mma_sync(acc[j], a, b, acc[j]);
                }
            }
            __syncthreads();   // every warp done with this A tile
            if (hit >= 0) a_s[threadIdx.x * A_LD + hit] = zero;
        }
        // epilogue: each warp rounds its 16 rows to bf16, 8 columns a lane
        const int r = lane / 2, c = (lane % 2) * 8;
        for (int j = 0; j < W / 16; ++j) {
            wmma::store_matrix_sync(c_s[warp], acc[j], 16, wmma::mem_row_major);
            __syncwarp();
            __align__(16) __nv_bfloat16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(c_s[warp][r * 16 + c + e]);
            *reinterpret_cast<uint4*>(out + (m0 + warp * 16 + r) * W + j * 16 + c) =
                *reinterpret_cast<const uint4*>(v);
            __syncwarp();
        }
    }
}

}  // namespace

extern "C" int take_gather_launch(const void* table, int n_table_rows,
                                  const void* rows, long long n, int block,
                                  void* out, void* stream) {
    if (block < 1 || n % block) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    take_kernel<<<(unsigned)(n / block), TAKE_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, n_table_rows, (const int*)rows, block, (uint4*)out);
    return (int)cudaGetLastError();
}

extern "C" int onehot_gather_launch(const void* table, int n_table_rows,
                                    const void* rows, long long n, int block,
                                    void* out, void* stream) {
    if (block < OH_M || block % OH_M || n % block || n_table_rows % OH_K)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    onehot_kernel<<<(unsigned)(n / block), OH_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)table, n_table_rows, (const int*)rows, block,
        (__nv_bfloat16*)out);
    return (int)cudaGetLastError();
}
