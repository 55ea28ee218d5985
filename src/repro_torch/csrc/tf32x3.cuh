// 3xTF32 tensor-core products and cp.async staging for Hopper (sm_90a).
//
// Shared by distance.cu, qdist.cu and flash.cu.  A TF32 tensor-core
// product keeps 10 bits of each operand's mantissa: one pass misses the
// reference's tolerances (rtol 1e-4 / atol 2e-3 on distances at d = 960).
// So each fp32 operand x is split into two TF32 values,
//
//     hi = cvt.rna.tf32(x),   lo = cvt.rna.tf32(x - hi),
//
// and a product a * b is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
// (the small cross terms first, lo_a * lo_b dropped), all accumulated in
// fp32: about fp32 accuracy at three tensor-core passes.  This is CUTLASS's
// OpMultiplyAddFastF32.  A bf16 operand is exact in TF32 (lo = 0), and so
// is an int8 code (qdist.cu), so the passes with its lo factor are skipped
// (template flags below).  distance.cu and flash.cu keep raw fp32 in
// shared memory; the split happens in registers as a fragment is read.
//
// mma.sync.m16n8k8 (row.col, tf32 in, f32 accumulate): with
// g = lane / 4 and t = lane % 4, each lane holds
//
//     A (16 x 8, row-major):  a0 (g, t)   a1 (g + 8, t)
//                             a2 (g, t+4) a3 (g + 8, t + 4)
//     B (8 x 8, k x n):       b0 (k = t, n = g)   b1 (k = t + 4, n = g)
//     C (16 x 8):             c0 (g, 2t)     c1 (g, 2t + 1)
//                             c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
//
// The k index of A and B may be permuted (the same way in both): the sum
// over k does not see its order.  flash.cu uses that to feed the C fragment
// of one product straight back as the A fragment of the next.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// cvt.rna.tf32.f32: round to the nearest TF32 value, ties away from zero
// (in bits: (x + 0x1000) & ~0x1FFF); the result is an fp32 bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c += a * b, one m16n8k8 TF32 tensor-core product.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i][j] += a[i] * b[j] over M x N fragment pairs in 3xTF32, pass by pass
// (every lo * hi, then every hi * lo, then every hi * hi), so that
// consecutive mma.sync write different accumulators and none waits on the
// last.  The cross terms go to their own accumulators cx (add them to c at
// the end), so the chain of dependent products on one accumulator is a
// third as long.  A_EXACT / B_EXACT say that operand's lo is 0 (a bf16
// source), and skip its pass.
template <bool A_EXACT, bool B_EXACT, int M, int N>
__device__ __forceinline__ void mma3_tiles(float (&c)[M][N][4],
                                           float (&cx)[M][N][4],
                                           const uint32_t (&ah)[M][4],
                                           const uint32_t (&al)[M][4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
    if constexpr (!A_EXACT) {
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) mma(cx[i][j], al[i], bh[j]);
    }
    if constexpr (!B_EXACT) {
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) mma(cx[i][j], ah[i], bl[j]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) mma(c[i][j], ah[i], bh[j]);
}

// One A fragment against N B fragments in 3xTF32, pass by pass as above,
// all three passes into c.
template <bool A_EXACT, bool B_EXACT, int N>
__device__ __forceinline__ void mma3_row(float (&c)[N][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[N][2],
                                         const uint32_t (&bl)[N][2]) {
    if constexpr (!A_EXACT) {
#pragma unroll
        for (int j = 0; j < N; ++j) mma(c[j], al, bh[j]);
    }
    if constexpr (!B_EXACT) {
#pragma unroll
        for (int j = 0; j < N; ++j) mma(c[j], ah, bl[j]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) mma(c[j], ah, bh[j]);
}

// ldmatrix.x4 of 32-bit words: lane i gives the address of row i % 8 of
// 8 x 4-word matrix i / 8 (16-byte aligned), and receives, of each matrix
// m, the word (row lane / 4, column lane % 4) in r[m]: the A or B fragment
// layout above, one instruction for four shared-memory loads.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The A fragment at (row 0, k 0) of a row-major fp32 tile with `ld` floats
// per row (a multiple of 4): matrices (rows 0-7, k 0-3), (8-15, 0-3),
// (0-7, 4-7), (8-15, 4-7) are a0..a3.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const float* s,
                                           int ld, int lane) {
    const int m = lane >> 3, r = lane & 7;
    ldmatrix_x4(a, s + ((m & 1) * 8 + r) * ld + (m >> 1) * 4);
}

// The B fragments of n-tiles 0 and 1 of a tile stored as [n][k] rows:
// matrices (n 0-7, k 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) are b0, b1
// of tile 0 and b0, b1 of tile 1.
__device__ __forceinline__ void ldmatrix_b2(uint32_t (&b)[4], const float* s,
                                            int ld, int lane) {
    const int m = lane >> 3, r = lane & 7;
    ldmatrix_x4(b, s + ((m >> 1) * 8 + r) * ld + (m & 1) * 4);
}

// 16-byte global -> shared copy that bypasses L1; `valid` false fills the
// 16 bytes with zeros and reads nothing (src must still be a mapped
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The number of SMs of the current device (132 on an H100 SXM), read once:
// the launchers size their grids by it.
inline int sm_count() {
    static const int n = [] {
        int dev = 0, v = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess)
            v = 132;
        return v;
    }();
    return n;
}

}  // namespace tf32x3
