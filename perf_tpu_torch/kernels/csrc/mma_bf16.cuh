// Warp-level bf16 tensor-core products for sm_80 and later: mma.sync
// m16n8k16 (bf16 x bf16, float32 sums) and the ldmatrix loads that fill its
// fragments from shared memory. Device code only.
//
// Fragments (PTX ISA, "mma.m16n8k16"), lane = 4 * gq + tq:
//   A 16 x 16 (row): a[0] = (gq, 2tq..2tq+1), a[1] = (gq + 8, 2tq..),
//                    a[2] = (gq, 2tq + 8..), a[3] = (gq + 8, 2tq + 8..)
//   B 16 x 8 (col):  b0 = (k 2tq..2tq+1, n gq), b1 = (k 2tq + 8.., n gq)
//   C 16 x 8 f32:    c[0..1] = (gq, 2tq..2tq+1), c[2..3] = (gq + 8, 2tq..)
// Each 32-bit register holds two bf16, the lower column in the low half.
// ldmatrix x4: lanes 8i..8i+7 give the row addresses of 8 x 8 matrix i,
// which lands in register i; without .trans lane l reads (l / 4, 2 (l % 4)
// ..+1) of each matrix, with .trans (2 (l % 4)..+1, l / 4).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// d += A B, chained in the tensor cores' own sum
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B: the k16 product summed into zeros, then added to c with a
// rounded float32 add, so the tensor cores' internal sum (products aligned
// to the largest and truncated) never carries more than 16 products
__device__ __forceinline__ void mma_add_16816(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16_16816(t, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
