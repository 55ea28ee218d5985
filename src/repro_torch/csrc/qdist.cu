// int8 asymmetric distance for Hopper (sm_90a), fp32 on the CUDA cores.
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
// the plain version's sum((xq s)^2): the codes' sum of squares is exact (an
// int32 sum in the cell scan, an fp32 sum of integers below 2^24 in the
// all-pairs entry while d <= 1040), and the two forms differ by fp32
// rounding only (relative
// ~1e-7), far inside the tolerance the reference holds the kernel to (rtol
// 1e-4, atol 2e-3).  q is fp32 or bf16; every product and sum is fp32 (no
// TF32).
//
// Two entries:
//
// * qdist_launch -- all pairs, out (nq, nx): the Pallas kernel's function.
//   One 64 x 64 output tile per block of 256 threads, each thread a 4 x 4
//   register micro-tile, d staged 32 wide through shared memory as in
//   distance.cu; the int8 codes are widened to float as they are staged and
//   the scale is applied once per output in the epilogue.  Ragged nq, nx and
//   d are masked at the loads and stores (no host padding).  At (64 x 8192 x
//   128) the work is 134 MFLOP against 1.1 MB of int8 rows and 2 MB of
//   output: the operation bound (2.0 us at 67 TFLOP/s) is above the byte
//   bound (0.93 us).
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

namespace {

constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// all pairs
// ---------------------------------------------------------------------------
constexpr int BM = 64;      // q rows per block
constexpr int BN = 64;      // int8 rows per block
constexpr int BK = 32;      // depth staged per step
constexpr int TM = 4;       // micro-tile rows per thread
constexpr int TN = 4;       // micro-tile cols per thread
constexpr int THREADS = 256;
constexpr int PAD = 4;      // keeps rows 16-byte aligned, spreads banks

template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS)
qdist_kernel(const T* __restrict__ q, const int8_t* __restrict__ x,
             const float* __restrict__ scale, float* __restrict__ out,
             int nq, int nx, int d) {
    __shared__ __align__(16) float As[BK][BM + PAD];   // As[k][m] = q[m][k]
    __shared__ __align__(16) float Bs[BK][BN + PAD];   // Bs[k][n] = x[n][k]
    __shared__ float qn_s[BM];
    __shared__ float xn_s[BN];
    __shared__ float sc_s[BN];

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);     // 0..15: column group
    const int ty = tid / (BN / TN);     // 0..15: row group
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    if (tid < BN) sc_s[tid] = (col0 + tid < nx) ? scale[col0 + tid] : 0.f;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float norm = 0.f;   // threads < BM + BN own one row's squared norm

    for (int k0 = 0; k0 < d; k0 += BK) {
        // stage: consecutive threads read consecutive depth of one row
        for (int e = tid; e < BM * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gk = k0 + c;
            const int gq = row0 + r, gx = col0 + r;
            As[c][r] = (gq < nq && gk < d)
                ? to_f32(q[(size_t)gq * d + gk]) : 0.f;
            Bs[c][r] = (gx < nx && gk < d)
                ? static_cast<float>(x[(size_t)gx * d + gk]) : 0.f;
        }
        __syncthreads();

        if (L2) {
            if (tid < BM) {
#pragma unroll 8
                for (int c = 0; c < BK; ++c) norm = fmaf(As[c][tid], As[c][tid], norm);
            } else if (tid < BM + BN) {
                const int r = tid - BM;
#pragma unroll 8
                for (int c = 0; c < BK; ++c) norm = fmaf(Bs[c][r], Bs[c][r], norm);
            }
        }

#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

    if (L2) {
        if (tid < BM) qn_s[tid] = norm;
        else if (tid < BM + BN) xn_s[tid - BM] = norm;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c >= nx) continue;
            const float s = sc_s[tx * TN + j];
            const float v = L2
                ? qn_s[ty * TM + i] + s * s * xn_s[tx * TN + j]
                      - 2.f * s * acc[i][j]
                : -s * acc[i][j];
            out[(size_t)r * nx + c] = v;
        }
    }
}

template <typename T>
void launch_pairs(const void* q, const void* x, const float* scale, float* out,
                  int nq, int nx, int d, int metric, cudaStream_t stream) {
    const dim3 grid((nx + BN - 1) / BN, (nq + BM - 1) / BM);
    const T* qp = static_cast<const T*>(q);
    const int8_t* xp = static_cast<const int8_t*>(x);
    if (metric == 0)
        qdist_kernel<T, true><<<grid, THREADS, 0, stream>>>(qp, xp, scale, out, nq, nx, d);
    else
        qdist_kernel<T, false><<<grid, THREADS, 0, stream>>>(qp, xp, scale, out, nq, nx, d);
}

// ---------------------------------------------------------------------------
// cell scan
// ---------------------------------------------------------------------------
constexpr int SCAN_THREADS = 128;   // slots per block

// signed byte i (0..3, little-endian) of a packed word, as a float
__device__ __forceinline__ float byte_f(int w, int i) {
    return static_cast<float>(
        static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * i)) >> 24);
}

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
// metric: 0 = l2, 1 = ip.  dtype of q: 0 = fp32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int qdist_launch(const void* q, const void* xq, const void* scale,
                            void* out, int nq, int nx, int d, int metric,
                            int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sp = static_cast<const float*>(scale);
    float* op = static_cast<float*>(out);
    if (dtype == 0)
        launch_pairs<float>(q, xq, sp, op, nq, nx, d, metric, s);
    else
        launch_pairs<__nv_bfloat16>(q, xq, sp, op, nq, nx, d, metric, s);
    return static_cast<int>(cudaGetLastError());
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
