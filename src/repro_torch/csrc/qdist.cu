// int8 asymmetric distance for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/qdist/qdist.py::qdist (the Pallas TPU kernel
// behind repro.kernels.qdist.ops.quantized_distance).
//
// A float query q against an int8 row xq with its per-row fp32 scale s, the
// distance to the dequantized row xq * s:
//
//   l2: ||q||^2 + s^2 * sum(xq^2) - 2 s (q . xq)
//   ip: -s (q . xq)
//
// The norm term is the Pallas wrapper's s^2 * sum(xq^2) (qdist.py:66), not
// the plain version's sum((xq s)^2): the codes' sum of squares is an exact
// int32 sum (__dp4a) in both entries, and the two forms differ by fp32
// rounding only (relative ~1e-7), far inside the tolerance the reference
// holds the kernel to (rtol 1e-4, atol 2e-3).  q is fp32 or bf16.
//
// Two entries:
//
// * qdist_launch -- all pairs, out (nq, nx): the Pallas kernel's function,
//   on the tensor cores (mma.sync m16n8k8 TF32, csrc/tf32x3.cuh).  An int8
//   code is exact in TF32 (11-bit significand: every integer in
//   [-127, 127]), so its lo part is 0 and a product takes two passes,
//   q_lo * c then q_hi * c, accumulated in fp32: the accuracy of 3xTF32 at
//   two thirds of its tensor-core work.  A bf16 query is exact too: one
//   pass.  The scale is applied once per output in the epilogue.
//
//   What bounds it on the H100: at the brute-force shape (64 x 8192 x 128)
//   the call moves 3.2 MB (q and the int8 rows with their scales read
//   once, out written once: 0.96 us at 3.35 TB/s) and does 134 MFLOP of
//   products, 2 x 134 in two TF32 passes (0.54 us at 495 TFLOP/s): bytes
//   bound it.  On the CUDA cores the products alone take 2.0 us.
//
//   Design: distance.cu's tiles.  A block of 4 warps owns a 64 x 64 output
//   tile (32 x 32 per warp) where that gives at least every other SM a
//   block, else 32 x 32 (16 x 16 per warp).  d is staged 32 wide through a
//   3-stage cp.async ring: q as fp32 rows of 48 floats, the codes as int8
//   rows of 48 bytes, 16 codes per 16-byte copy (a quarter of distance's
//   bytes for the same rows).  Fragments are read straight from the slabs
//   with the k index permuted alike in A and B (tf32x3.cuh): over 16 deep,
//   lane (g, t) takes depth 4t .. 4t+3, k = t and t + 4 of the first
//   m16n8k8 product being depth 4t and 4t+1, of the second 4t+2 and 4t+3.
//   So one float4 per A row and one 32-bit word of four codes per B column
//   feed two products; the codes are widened to float as the word is
//   unpacked.  Row strides of 48 floats (16 mod 32 words) and 48 bytes (12
//   words) make both reads conflict-free.  Threads 0..BM-1 sum a q row's
//   squares in fp32, threads BM..BM+BN-1 a code row's in int32 (__dp4a),
//   from the same slabs.  Ragged nq, nx and d are masked in the kernel.
//
//   Alignment: the cp.async variant needs fp32 queries, d % 16 == 0 and
//   16-byte aligned q and xq.  Anything else (d = 25, views one element off
//   16 bytes, bf16 queries) takes the variant that stages element by
//   element (4-byte query loads, 1-byte code loads) into the same slabs.
//   Both are the kernel.
//
// * qdist_cells_launch -- the IVF cell scan, out (B, nprobe * pad):
//   slot j * pad + t of query b scores the row at position
//   cells[rows[b, j], t], the layout of the reference's
//   cells[probe].reshape(B, -1) (backends/ivf.py:111), so a cut that breaks
//   ties by slot sees the same order.  A slot is BIG (3e38) where the
//   position is -1 (cell padding) or rows[b, j] is -1 (a probed cell another
//   shard owns).  The rows are read in place: the dequantized (B, nprobe *
//   pad, d) block the reference gathers is never built.  One thread per
//   slot, blocks of 128 slots of one (query, probed cell); the query sits in
//   shared memory, each thread streams its own 16-byte-aligned row with
//   16-byte loads (one byte at a time when d % 16 != 0), sums q * code in
//   fp32 and code^2 with __dp4a in int32.  Bound: the bytes of the probed
//   rows (about 128 MB per batch of 64 queries x 16 cells at the 1M x 128
//   layout, 38 us at 3.35 TB/s) unless the L2 holds cells that several
//   queries of the batch probe.  Grouping the queries that share a cell, so
//   that its rows are read once, is left for a later version; so are wgmma
//   and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// signed byte i (0..3, little-endian) of a packed word, as a float
__device__ __forceinline__ float byte_f(int w, int i) {
    return static_cast<float>(
        static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * i)) >> 24);
}

// ---------------------------------------------------------------------------
// all pairs
// ---------------------------------------------------------------------------
constexpr int BK = 32;          // depth staged per slab
constexpr int LDA = BK + 16;    // q slab row stride, floats (16 mod 32 words)
constexpr int LDB = BK + 16;    // code slab row stride, bytes (12 words)

// A block's output tile (BM q rows x BN code rows), each warp's (WM x WN,
// in m16 x n8 fragments), and the stages of the cp.async ring.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tiles {
    static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int MI = WM / 16, NJ = WN / 8;
    static constexpr int THREADS = 32 * (BM / WM) * (BN / WN);
    static_assert(BM + BN <= THREADS, "a thread per row sums the squared norms");
    static_assert(STAGES * (BM * LDA * 4 + BN * LDB) + 4 * (BM + 2 * BN)
                      <= 48 * 1024,
                  "the ring fits in static shared memory");
};
using Narrow = Tiles<32, 32, 16, 16, 3>;
using Wide = Tiles<64, 64, 32, 32, 3>;

// Stage depth [k0, k0 + BK) of ROWS query rows from row0 (n rows of d) as
// fp32, zero past n and d.
template <int ROWS, int THREADS, typename T, bool ASYNC>
__device__ __forceinline__ void stage_q(float* dst, const T* src, int row0,
                                        int n, int d, int k0, int tid) {
    if constexpr (ASYNC) {
        for (int e = tid; e < ROWS * BK / 4; e += THREADS) {
            const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
            const int gr = row0 + r, gk = k0 + c;
            const bool ok = gr < n && gk < d;
            tf32x3::cp_async16(dst + r * LDA + c,
                               ok ? src + (size_t)gr * d + gk : src, ok);
        }
    } else {
        for (int e = tid; e < ROWS * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gr = row0 + r, gk = k0 + c;
            dst[r * LDA + c] = (gr < n && gk < d)
                ? to_f32(src[(size_t)gr * d + gk]) : 0.f;
        }
    }
}

// The same for ROWS int8 code rows, kept as int8.
template <int ROWS, int THREADS, bool ASYNC>
__device__ __forceinline__ void stage_x(int8_t* dst, const int8_t* src,
                                        int row0, int n, int d, int k0,
                                        int tid) {
    if constexpr (ASYNC) {
        for (int e = tid; e < ROWS * BK / 16; e += THREADS) {
            const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
            const int gr = row0 + r, gk = k0 + c;
            const bool ok = gr < n && gk < d;
            tf32x3::cp_async16(dst + r * LDB + c,
                               ok ? src + (size_t)gr * d + gk : src, ok);
        }
    } else {
        for (int e = tid; e < ROWS * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gr = row0 + r, gk = k0 + c;
            dst[r * LDB + c] = (gr < n && gk < d) ? src[(size_t)gr * d + gk]
                                                  : static_cast<int8_t>(0);
        }
    }
}

template <class C, typename T, bool L2, bool ASYNC>
__global__ void __launch_bounds__(C::THREADS)
qdist_kernel(const T* __restrict__ q, const int8_t* __restrict__ x,
             const float* __restrict__ scale, float* __restrict__ out,
             int nq, int nx, int d) {
    constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
    constexpr int BM = C::BM, BN = C::BN, WM = C::WM, WN = C::WN;
    constexpr int MI = C::MI, NJ = C::NJ, STAGES = C::STAGES, THREADS = C::THREADS;
    __shared__ __align__(16) float As[STAGES][BM * LDA];    // As[s][m][k]
    __shared__ __align__(16) int8_t Bs[STAGES][BN * LDB];   // Bs[s][n][k]
    __shared__ float qn_s[BM];
    __shared__ float xn_s[BN];
    __shared__ float sc_s[BN];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q_tiles = (nq + BM - 1) / BM;
    const int row0 = (int)(blockIdx.x % q_tiles) * BM;
    const int col0 = (int)(blockIdx.x / q_tiles) * BN;
    const int wm = (warp % (BM / WM)) * WM;   // the warp's rows in the tile
    const int wn = (warp / (BM / WM)) * WN;   // and its columns

    if (tid < BN) sc_s[tid] = (col0 + tid < nx) ? scale[col0 + tid] : 0.f;

    float acc[MI][NJ][4], accx[MI][NJ][4];    // q_hi * c; q_lo * c
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = accx[i][j][e] = 0.f;
    // threads < BM own a q row's squared norm (fp32, 4 partial sums),
    // threads BM .. BM + BN - 1 a code row's (int32)
    float qn[4] = {0.f, 0.f, 0.f, 0.f};
    int xn = 0;

    const int slabs = (d + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < slabs) {
            stage_q<BM, THREADS, T, ASYNC>(As[s], q, row0, nq, d, s * BK, tid);
            stage_x<BN, THREADS, ASYNC>(Bs[s], x, col0, nx, d, s * BK, tid);
        }
        tf32x3::cp_async_commit();
    }
    for (int ks = 0; ks < slabs; ++ks) {
        // slab ks has landed for every thread; every warp is past slab ks-1
        tf32x3::cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int next = ks + STAGES - 1;
        if (next < slabs) {
            const int sn = next % STAGES;
            stage_q<BM, THREADS, T, ASYNC>(As[sn], q, row0, nq, d, next * BK, tid);
            stage_x<BN, THREADS, ASYNC>(Bs[sn], x, col0, nx, d, next * BK, tid);
        }
        tf32x3::cp_async_commit();

        const float* A = As[ks % STAGES];
        const int8_t* B = Bs[ks % STAGES];
        if (L2) {
            if (tid < BM) {
                const float* row = A + tid * LDA;
#pragma unroll
                for (int c = 0; c < BK; ++c) {
                    const float v = row[(c + tid) & (BK - 1)];   // bank 17 tid + c
                    qn[c & 3] = fmaf(v, v, qn[c & 3]);
                }
            } else if (tid < BM + BN) {
                const int* row = reinterpret_cast<const int*>(B + (tid - BM) * LDB);
#pragma unroll
                for (int c = 0; c < BK / 4; ++c) {
                    const int w = row[(c + tid) & (BK / 4 - 1)];
                    xn = __dp4a(w, w, xn);
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            // depth kk + 4t .. kk + 4t + 3 of rows g and g + 8 of each A
            // fragment, and of column g of each B fragment
            float4 alo[MI], ahi[MI];
            int bw[NJ];
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const float* p = A + (wm + 16 * i + g) * LDA + kk + 4 * t;
                alo[i] = *reinterpret_cast<const float4*>(p);
                ahi[i] = *reinterpret_cast<const float4*>(p + 8 * LDA);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                bw[j] = *reinterpret_cast<const int*>(
                    B + (wn + 8 * j + g) * LDB + kk + 4 * t);
#pragma unroll
            for (int h = 0; h < 2; ++h) {   // depth 4t + 2h and 4t + 2h + 1
                uint32_t ah[MI][4], al[MI][4], bh[NJ][2];
#pragma unroll
                for (int i = 0; i < MI; ++i) {
                    const float a[4] = {h ? alo[i].z : alo[i].x,
                                        h ? ahi[i].z : ahi[i].x,
                                        h ? alo[i].w : alo[i].y,
                                        h ? ahi[i].w : ahi[i].y};
                    if constexpr (EXACT) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) ah[i][e] = al[i][e] = __float_as_uint(a[e]);
                    } else {
                        tf32x3::split(a, ah[i], al[i]);
                    }
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j) {   // a code is exact in TF32
                    bh[j][0] = __float_as_uint(byte_f(bw[j], 2 * h));
                    bh[j][1] = __float_as_uint(byte_f(bw[j], 2 * h + 1));
                }
                tf32x3::mma3_tiles<EXACT, true>(acc, accx, ah, al, bh, bh);
            }
        }
    }

    if (L2) {
        if (tid < BM) qn_s[tid] = (qn[0] + qn[1]) + (qn[2] + qn[3]);
        else if (tid < BM + BN) xn_s[tid - BM] = static_cast<float>(xn);
    }
    __syncthreads();

    const bool pairs = (nx & 1) == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows g and g + 8 of a fragment
            const int rl = wm + 16 * i + g + 8 * h;
            const int r = row0 + rl;
            if (r >= nq) continue;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int cl = wn + 8 * j + 2 * t;
                const int c = col0 + cl;
                const float s0 = sc_s[cl], s1 = sc_s[cl + 1];
                float v0 = acc[i][j][2 * h] + accx[i][j][2 * h];
                float v1 = acc[i][j][2 * h + 1] + accx[i][j][2 * h + 1];
                if (L2) {
                    v0 = qn_s[rl] + s0 * s0 * xn_s[cl] - 2.f * s0 * v0;
                    v1 = qn_s[rl] + s1 * s1 * xn_s[cl + 1] - 2.f * s1 * v1;
                } else {
                    v0 = -s0 * v0;
                    v1 = -s1 * v1;
                }
                float* o = out + (size_t)r * nx + c;
                if (pairs && c + 1 < nx) {
                    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                } else {
                    if (c < nx) o[0] = v0;
                    if (c + 1 < nx) o[1] = v1;
                }
            }
        }
    }
}

template <class C, typename T, bool ASYNC>
int launch(const T* q, const int8_t* x, const float* scale, float* out, int nq,
           int nx, int d, int metric, cudaStream_t stream) {
    const long long tiles = (long long)((nq + C::BM - 1) / C::BM) *
                            ((nx + C::BN - 1) / C::BN);
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)tiles);
    if (metric == 0)
        qdist_kernel<C, T, true, ASYNC><<<grid, C::THREADS, 0, stream>>>(
            q, x, scale, out, nq, nx, d);
    else
        qdist_kernel<C, T, false, ASYNC><<<grid, C::THREADS, 0, stream>>>(
            q, x, scale, out, nq, nx, d);
    return static_cast<int>(cudaGetLastError());
}

// The wide tiles where they give at least every other SM a block (the
// 64 x 8192 brute-force shape: 128 blocks), else the narrow.
template <typename T, bool ASYNC>
int launch_pairs(const void* q, const void* x, const float* scale, float* out,
                 int nq, int nx, int d, int metric, cudaStream_t stream) {
    const T* qp = static_cast<const T*>(q);
    const int8_t* xp = static_cast<const int8_t*>(x);
    const long long wide = (long long)((nq + Wide::BM - 1) / Wide::BM) *
                           ((nx + Wide::BN - 1) / Wide::BN);
    return 2 * wide >= tf32x3::sm_count()
        ? launch<Wide, T, ASYNC>(qp, xp, scale, out, nq, nx, d, metric, stream)
        : launch<Narrow, T, ASYNC>(qp, xp, scale, out, nq, nx, d, metric, stream);
}

// ---------------------------------------------------------------------------
// cell scan
// ---------------------------------------------------------------------------
constexpr int SCAN_THREADS = 128;   // slots per block

template <typename T, bool L2, bool VEC16>
__global__ void __launch_bounds__(SCAN_THREADS)
qdist_cells_kernel(const T* __restrict__ q, const int8_t* __restrict__ xq,
                   const float* __restrict__ scale,
                   const int* __restrict__ cells, const int* __restrict__ rows,
                   float* __restrict__ out, int nprobe, int pad, int n_cells,
                   int nx, int d) {
    extern __shared__ __align__(16) float qs[];    // the query, d floats
    __shared__ float qn_s;

    const int b = blockIdx.z, j = blockIdx.y;
    const int t = blockIdx.x * SCAN_THREADS + threadIdx.x;
    float* o = out + ((size_t)b * nprobe + j) * pad;
    const int row = rows[(size_t)b * nprobe + j];
    // -1 is "not probed here"; a row outside the table never comes from the
    // layout, and is treated the same so that it cannot read out of bounds
    if (row < 0 || row >= n_cells) {            // uniform over the block
        if (t < pad) o[t] = BIG;
        return;
    }
    for (int k = threadIdx.x; k < d; k += SCAN_THREADS)
        qs[k] = to_f32(q[(size_t)b * d + k]);
    __syncthreads();
    if (L2 && threadIdx.x < 32) {
        float s = 0.f;
        for (int k = threadIdx.x; k < d; k += 32) s = fmaf(qs[k], qs[k], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (threadIdx.x == 0) qn_s = s;
    }
    __syncthreads();
    if (t >= pad) return;

    const int p = cells[(size_t)row * pad + t];
    if (p < 0 || p >= nx) {
        o[t] = BIG;
        return;
    }
    const int8_t* x = xq + (size_t)p * d;
    float dot = 0.f;
    int sq = 0;
    if (VEC16) {
        for (int k0 = 0; k0 < d; k0 += 16) {
            const int4 w = *reinterpret_cast<const int4*>(x + k0);
            const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4 qv = *reinterpret_cast<const float4*>(&qs[k0 + 4 * u]);
                if (L2) sq = __dp4a(ws[u], ws[u], sq);
                dot = fmaf(qv.x, byte_f(ws[u], 0), dot);
                dot = fmaf(qv.y, byte_f(ws[u], 1), dot);
                dot = fmaf(qv.z, byte_f(ws[u], 2), dot);
                dot = fmaf(qv.w, byte_f(ws[u], 3), dot);
            }
        }
    } else {
        for (int k = 0; k < d; ++k) {
            const int v = x[k];
            sq += v * v;
            dot = fmaf(qs[k], static_cast<float>(v), dot);
        }
    }
    const float s = scale[p];
    o[t] = L2 ? qn_s + s * s * static_cast<float>(sq) - 2.f * s * dot
              : -s * dot;
}

template <typename T, bool L2>
void launch_cells_t(const T* q, const int8_t* xq, const float* scale,
                    const int* cells, const int* rows, float* out, int B,
                    int nprobe, int pad, int n_cells, int nx, int d, bool vec16,
                    cudaStream_t stream) {
    const dim3 grid((pad + SCAN_THREADS - 1) / SCAN_THREADS, nprobe, B);
    const size_t smem = sizeof(float) * d;
    if (vec16)
        qdist_cells_kernel<T, L2, true><<<grid, SCAN_THREADS, smem, stream>>>(
            q, xq, scale, cells, rows, out, nprobe, pad, n_cells, nx, d);
    else
        qdist_cells_kernel<T, L2, false><<<grid, SCAN_THREADS, smem, stream>>>(
            q, xq, scale, cells, rows, out, nprobe, pad, n_cells, nx, d);
}

template <typename T>
void launch_cells(const void* q, const void* xq, const float* scale,
                  const int* cells, const int* rows, float* out, int B,
                  int nprobe, int pad, int n_cells, int nx, int d, int metric,
                  cudaStream_t stream) {
    const T* qp = static_cast<const T*>(q);
    const int8_t* xp = static_cast<const int8_t*>(xq);
    const bool vec16 = d % 16 == 0
        && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
    if (metric == 0)
        launch_cells_t<T, true>(qp, xp, scale, cells, rows, out, B, nprobe, pad,
                                n_cells, nx, d, vec16, stream);
    else
        launch_cells_t<T, false>(qp, xp, scale, cells, rows, out, B, nprobe,
                                 pad, n_cells, nx, d, vec16, stream);
}

}  // namespace

// All pairs: out (nq, nx) <- qdist(q (nq, d), xq (nx, d) int8, scale (nx,)).
// metric: 0 = l2, 1 = ip.  dtype of q: 0 = fp32, 1 = bf16.  fp32 queries
// with d % 16 == 0 on 16-byte aligned q and xq stage with cp.async,
// everything else element by element.  Returns cudaGetLastError() after
// the launch (0 = success).
extern "C" int qdist_launch(const void* q, const void* xq, const void* scale,
                            void* out, int nq, int nx, int d, int metric,
                            int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(scale);
    float* op = static_cast<float*>(out);
    if (dtype != 0)
        return launch_pairs<__nv_bfloat16, false>(q, xq, sp, op, nq, nx, d,
                                                  metric, s);
    const bool aligned = d % 16 == 0
        && reinterpret_cast<uintptr_t>(q) % 16 == 0
        && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
    return aligned
        ? launch_pairs<float, true>(q, xq, sp, op, nq, nx, d, metric, s)
        : launch_pairs<float, false>(q, xq, sp, op, nq, nx, d, metric, s);
}

// Cell scan: out (B, nprobe * pad) <- for each probed cell rows[b, j] of
// cells (n_cells, pad), the distance from q[b] to the row at each position of
// that cell (BIG at -1).  xq (nx, d) int8, scale (nx,), cells and rows int32.
// metric and dtype as above.  Returns cudaGetLastError() after the launch.
extern "C" int qdist_cells_launch(const void* q, const void* xq,
                                  const void* scale, const void* cells,
                                  const void* rows, void* out, int B,
                                  int nprobe, int pad, int n_cells, int nx,
                                  int d, int metric, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(scale);
    const int* cp = static_cast<const int*>(cells);
    const int* rp = static_cast<const int*>(rows);
    float* op = static_cast<float*>(out);
    if (dtype == 0)
        launch_cells<float>(q, xq, sp, cp, rp, op, B, nprobe, pad, n_cells, nx,
                            d, metric, s);
    else
        launch_cells<__nv_bfloat16>(q, xq, sp, cp, rp, op, B, nprobe, pad,
                                    n_cells, nx, d, metric, s);
    return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
