// Batched distance matrix for Hopper (sm_90a), 3xTF32 on the tensor cores.
//
// Replaces: src/repro/kernels/distance/distance.py::distance (the Pallas
// TPU kernel behind repro.kernels.distance.ops.pairwise_distance).
//
//   l2: out[i, j] = ||q_i||^2 + ||x_j||^2 - 2 q_i . x_j
//   ip: out[i, j] = -q_i . x_j
//
// q (nq, d) and x (nx, d) are row-major fp32 or bf16; out (nq, nx) is fp32.
// The dot products are 3xTF32 mma.sync products (tf32x3.cuh): about fp32
// accuracy, which the reference's tolerance (rtol 1e-4, atol 2e-3 at
// d = 960) needs and one TF32 pass misses.  bf16 inputs are exact in TF32
// and take one pass.  The squared norms are fp32 FMAs.
//
// What bounds it on the H100: at the brute-force shape (64 x 8192 x 128) the
// call moves 6.3 MB (x read once, out written once: 1.9 us at 3.35 TB/s)
// and does 134 MFLOP of products, 3 x 134 in 3xTF32 (0.8 us at 495 TFLOP/s
// TF32): bytes bound it.  On the CUDA cores the same products would take
// 2.0 us at 67 TFLOP/s.  mma.sync does not reach wgmma's TF32 rate, and
// at 64 x 8192 there are one or two blocks per SM, so the latency of the
// first slab and of the dependent products is what the kernel pays beyond
// the bound.
//
// Design: each warp owns a WM x WN sub-tile of m16n8 accumulators, two per
// fragment pair (hi * hi and the cross terms, so each chain of dependent
// products is a third as long), and takes the three passes over all its
// fragments in turn.  A block of 4 warps owns a 64 x 64 output tile (32 x
// 32 per warp) where that still gives at least every other SM a block,
// else a 32 x 32 tile (16 x 16 per warp) so that small grids (the ivf
// coarse probe, 64 x 1,569) spread over more SMs.  d is staged in 32-wide
// slabs through a cp.async ring (2 or 3 stages, one barrier per slab; the
// copy of the next slabs overlaps the products of this one).  Shared rows
// are padded to 36 floats, so the ldmatrix fragment reads (4 words of
// 8 rows per phase, bank 4r + c) are conflict-free; one ldmatrix.x4 loads
// an A fragment or the B fragments of two n-tiles.  Threads 0..BM+BN-1
// sum one q or x row's squares from the same slabs in 4 partial sums,
// reading their row skewed by their index (bank 5r + c) so that no two
// collide.  The epilogue writes each C fragment's column pair as a float2.
// Blocks are numbered q tile first, so the blocks that share an x tile run
// side by side.
//
// Alignment: the cp.async variant needs fp32 rows of a multiple of 4
// floats on 16-byte aligned pointers.  Anything else (d % 4 != 0, a view
// offset by one float, bf16 rows, which are widened as they are staged)
// takes the variant that stages with 4-byte loads.  Both are the kernel;
// ragged nq, nx and d are masked in both, with no host-side padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int BK = 32;          // depth staged per slab
constexpr int LD = BK + 4;      // shared row stride: 16-byte rows, 4 mod 32 words

// A block's output tile (BM q rows x BN x rows), each warp's (WM x WN, in
// m16 x n8 fragments), and the stages of the cp.async ring.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tiles {
    static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int MI = WM / 16, NJ = WN / 8;
    static constexpr int THREADS = 32 * (BM / WM) * (BN / WN);
    static_assert(NJ % 2 == 0, "B fragments are loaded two n-tiles at a time");
    static_assert(BM + BN <= THREADS, "a thread per row sums the squared norms");
    static_assert(sizeof(float) * (STAGES * (BM + BN) * LD + BM + BN) <= 48 * 1024,
                  "the ring fits in static shared memory");
};
// Small grids (the ivf coarse probe: 64 x 1,569) take 32 x 32 tiles, so
// that more blocks share the work; larger ones 64 x 64 tiles of 32 x 32 per
// warp, which load and split each operand fragment once for twice the
// products.
using Narrow = Tiles<32, 32, 16, 16, 3>;
using Wide = Tiles<64, 64, 32, 32, 2>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// Stage depth [k0, k0 + BK) of ROWS rows from row0 of src (n rows of d)
// into dst, zero past n and d.
template <int ROWS, int THREADS, typename T, bool ASYNC>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n, int d, int k0, int tid) {
    if constexpr (ASYNC) {
        for (int e = tid; e < ROWS * BK / 4; e += THREADS) {
            const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
            const int gr = row0 + r, gk = k0 + c;
            const bool ok = gr < n && gk < d;
            tf32x3::cp_async16(dst + r * LD + c,
                               ok ? src + (size_t)gr * d + gk : src, ok);
        }
    } else {
        for (int e = tid; e < ROWS * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gr = row0 + r, gk = k0 + c;
            dst[r * LD + c] = (gr < n && gk < d)
                ? to_f32(src[(size_t)gr * d + gk]) : 0.f;
        }
    }
}

template <class C, typename T, bool L2, bool ASYNC>
__global__ void __launch_bounds__(C::THREADS)
distance_kernel(const T* __restrict__ q, const T* __restrict__ x,
                float* __restrict__ out, int nq, int nx, int d) {
    constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
    constexpr int BM = C::BM, BN = C::BN, WM = C::WM, WN = C::WN;
    constexpr int MI = C::MI, NJ = C::NJ, STAGES = C::STAGES, THREADS = C::THREADS;
    __shared__ __align__(16) float As[STAGES][BM * LD];   // As[s][m][k]
    __shared__ __align__(16) float Bs[STAGES][BN * LD];   // Bs[s][n][k]
    __shared__ float qn_s[BM];
    __shared__ float xn_s[BN];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q_tiles = (nq + BM - 1) / BM;
    const int row0 = (int)(blockIdx.x % q_tiles) * BM;
    const int col0 = (int)(blockIdx.x / q_tiles) * BN;
    const int wm = (warp % (BM / WM)) * WM;   // the warp's rows in the tile
    const int wn = (warp / (BM / WM)) * WN;   // and its columns

    float acc[MI][NJ][4], accx[MI][NJ][4];    // hi * hi; the cross terms
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = accx[i][j][e] = 0.f;
    // threads < BM + BN own one row's squared norm, in 4 partial sums
    float norm[4] = {0.f, 0.f, 0.f, 0.f};

    const int slabs = (d + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < slabs) {
            stage<BM, THREADS, T, ASYNC>(As[s], q, row0, nq, d, s * BK, tid);
            stage<BN, THREADS, T, ASYNC>(Bs[s], x, col0, nx, d, s * BK, tid);
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
            stage<BM, THREADS, T, ASYNC>(As[sn], q, row0, nq, d, next * BK, tid);
            stage<BN, THREADS, T, ASYNC>(Bs[sn], x, col0, nx, d, next * BK, tid);
        }
        tf32x3::cp_async_commit();

        const float* A = As[ks % STAGES];
        const float* B = Bs[ks % STAGES];
        if (L2 && tid < BM + BN) {
            const float* row = tid < BM ? A + tid * LD : B + (tid - BM) * LD;
#pragma unroll
            for (int c = 0; c < BK; ++c) {
                const float v = row[(c + tid) & (BK - 1)];
                norm[c & 3] = fmaf(v, v, norm[c & 3]);
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                uint32_t af[4];
                tf32x3::ldmatrix_a(af, A + (wm + 16 * i) * LD + kk, LD, lane);
                tf32x3::split(af, ah[i], al[i]);
            }
#pragma unroll
            for (int j = 0; j < NJ; j += 2) {
                uint32_t bf[4], h[4], l[4];
                tf32x3::ldmatrix_b2(bf, B + (wn + 8 * j) * LD + kk, LD, lane);
                tf32x3::split(bf, h, l);
                bh[j][0] = h[0], bh[j][1] = h[1], bh[j + 1][0] = h[2], bh[j + 1][1] = h[3];
                bl[j][0] = l[0], bl[j][1] = l[1], bl[j + 1][0] = l[2], bl[j + 1][1] = l[3];
            }
            tf32x3::mma3_tiles<EXACT, EXACT>(acc, accx, ah, al, bh, bl);
        }
    }

    if (L2) {
        const float n2 = (norm[0] + norm[1]) + (norm[2] + norm[3]);
        if (tid < BM) qn_s[tid] = n2;
        else if (tid < BM + BN) xn_s[tid - BM] = n2;
        __syncthreads();
    }

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
                float v0 = acc[i][j][2 * h] + accx[i][j][2 * h];
                float v1 = acc[i][j][2 * h + 1] + accx[i][j][2 * h + 1];
                if (L2) {
                    v0 = qn_s[rl] + xn_s[cl] - 2.f * v0;
                    v1 = qn_s[rl] + xn_s[cl + 1] - 2.f * v1;
                } else {
                    v0 = -v0;
                    v1 = -v1;
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
int launch(const T* q, const T* x, float* out, int nq, int nx, int d,
           int metric, cudaStream_t stream) {
    const long long tiles = (long long)((nq + C::BM - 1) / C::BM) *
                            ((nx + C::BN - 1) / C::BN);
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)tiles);
    if (metric == 0)
        distance_kernel<C, T, true, ASYNC><<<grid, C::THREADS, 0, stream>>>(
            q, x, out, nq, nx, d);
    else
        distance_kernel<C, T, false, ASYNC><<<grid, C::THREADS, 0, stream>>>(
            q, x, out, nq, nx, d);
    return static_cast<int>(cudaGetLastError());
}

// The wide tiles where they give at least every other SM a block (the
// 64 x 8192 brute-force chunk: 128 blocks), else the narrow.
template <typename T, bool ASYNC>
int launch_tiles(const void* q, const void* x, void* out, int nq, int nx,
                 int d, int metric, cudaStream_t stream) {
    const T* qp = static_cast<const T*>(q);
    const T* xp = static_cast<const T*>(x);
    float* op = static_cast<float*>(out);
    const long long wide = (long long)((nq + Wide::BM - 1) / Wide::BM) *
                           ((nx + Wide::BN - 1) / Wide::BN);
    return 2 * wide >= tf32x3::sm_count()
        ? launch<Wide, T, ASYNC>(qp, xp, op, nq, nx, d, metric, stream)
        : launch<Narrow, T, ASYNC>(qp, xp, op, nq, nx, d, metric, stream);
}

}  // namespace

// metric: 0 = l2, 1 = ip.  dtype: 0 = fp32, 1 = bf16.  fp32 rows of a
// multiple of 4 floats on 16-byte aligned pointers stage with cp.async,
// everything else with 4-byte loads.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int distance_launch(const void* q, const void* x, void* out,
                               int nq, int nx, int d, int metric, int dtype,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype != 0)
        return launch_tiles<__nv_bfloat16, false>(q, x, out, nq, nx, d, metric, s);
    const bool aligned = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
                         && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    return aligned ? launch_tiles<float, true>(q, x, out, nq, nx, d, metric, s)
                   : launch_tiles<float, false>(q, x, out, nq, nx, d, metric, s);
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
