// Batched distance matrix for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/distance/distance.py::distance (the Pallas
// TPU kernel behind repro.kernels.distance.ops.pairwise_distance).
//
//   l2: out[i, j] = ||q_i||^2 + ||x_j||^2 - 2 q_i . x_j
//   ip: out[i, j] = -q_i . x_j
//
// q (nq, d) and x (nx, d) are row-major fp32 or bf16; out (nq, nx) is fp32.
// Every product and sum is fp32 (no TF32), which the reference's tolerance
// (rtol 1e-4, atol 2e-3 at d = 960) needs.
//
// What bounds it on the H100: at the brute-force shape (64 x 8192 x 128) the
// work is 134 MFLOP against 6 MB of traffic (x read once, out written once),
// about 22 FLOP per byte.  Plain fp32 peaks at 67 TFLOP/s, so the operation
// bound (2.0 us) and the byte bound (1.8 us at 3.35 TB/s) are close: the
// kernel needs both full-width loads and a dense FMA inner loop to approach
// either.
//
// Design: one 64 x 64 output tile per block of 256 threads, each thread a
// 4 x 4 register micro-tile; d is staged through shared memory 32 wide,
// stored transposed so the inner loop reads a column of each operand as a
// broadcast / contiguous row.  The squared norms come from the same staged
// tiles (threads 0..63 own a q row, 64..127 an x row), so nothing is read
// twice and no host pre-pass runs.  Ragged nq, nx and d are masked at the
// loads and stores: no host-side padding.  wgmma, TMA and pipelining are
// left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;      // q rows per block
constexpr int BN = 64;      // x rows per block
constexpr int BK = 32;      // depth staged per step
constexpr int TM = 4;       // micro-tile rows per thread
constexpr int TN = 4;       // micro-tile cols per thread
constexpr int THREADS = 256;
constexpr int PAD = 4;      // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS)
distance_kernel(const T* __restrict__ q, const T* __restrict__ x,
                float* __restrict__ out, int nq, int nx, int d) {
    __shared__ __align__(16) float As[BK][BM + PAD];   // As[k][m] = q[m][k]
    __shared__ __align__(16) float Bs[BK][BN + PAD];   // Bs[k][n] = x[n][k]
    __shared__ float qn_s[BM];
    __shared__ float xn_s[BN];

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);     // 0..15: column group
    const int ty = tid / (BN / TN);     // 0..15: row group
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

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
                ? to_f32(x[(size_t)gx * d + gk]) : 0.f;
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
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c >= nx) continue;
            const float v = L2
                ? qn_s[ty * TM + i] + xn_s[tx * TN + j] - 2.f * acc[i][j]
                : -acc[i][j];
            out[(size_t)r * nx + c] = v;
        }
    }
}

template <typename T>
void launch(const void* q, const void* x, void* out, int nq, int nx, int d,
            int metric, cudaStream_t stream) {
    const dim3 grid((nx + BN - 1) / BN, (nq + BM - 1) / BM);
    const T* qp = static_cast<const T*>(q);
    const T* xp = static_cast<const T*>(x);
    float* op = static_cast<float*>(out);
    if (metric == 0)
        distance_kernel<T, true><<<grid, THREADS, 0, stream>>>(qp, xp, op, nq, nx, d);
    else
        distance_kernel<T, false><<<grid, THREADS, 0, stream>>>(qp, xp, op, nq, nx, d);
}

}  // namespace

// metric: 0 = l2, 1 = ip.  dtype: 0 = fp32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int distance_launch(const void* q, const void* x, void* out,
                               int nq, int nx, int d, int metric, int dtype,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        launch<float>(q, x, out, nq, nx, d, metric, s);
    else
        launch<__nv_bfloat16>(q, x, out, nq, nx, d, metric, s);
    return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
