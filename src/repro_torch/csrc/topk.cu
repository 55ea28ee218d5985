// k smallest per row for Hopper (sm_90a): one block per row.
//
// Replaces: src/repro/kernels/topk/topk.py::topk_smallest (the Pallas TPU
// kernel behind repro.kernels.topk.ops.topk_smallest).
//
//   vals[i, :] = the k smallest of d[i, :], ascending (fp32)
//   idx[i, :]  = their column indices (int32); ties go to the lowest index
//
// Semantics follow the plain version (a stable ascending sort cut at k),
// not the Pallas body, in one place: once a row runs out of values below
// BIG, the Pallas kernel overwrites the winner with BIG and picks the same
// lowest index again.  Here a taken slot gets a sentinel key above every
// real key, so the k indices of a row are always distinct.
//
// What bounds it on the H100: the bytes.  Each row is read once and k
// pairs are written; at the brute-force shape (64 x 8192, k = 10) that is
// 2 MB, 0.6 us at 3.35 TB/s.  With one block per row only nq blocks run
// (64 here, half the 132 SMs), so one block must stream its row at a good
// fraction of one SM's share of the bandwidth.
//
// Design: the block stages its row in shared memory once (16-byte loads,
// several in flight per thread), as 32-bit keys
// whose unsigned order is the float order (-0 folded onto +0 so they tie,
// NaN above +inf, as a stable sort places them).  A (key, index) pair packs
// into one 64-bit word, so "smaller value, then lower index" is a plain
// unsigned min.  Each thread keeps the min of its own strided slots; a
// round reduces those minima across the block (warp shuffles, then one
// word per warp), takes the winner, marks its slot taken, and only the
// thread that owned the winner rescans its slots.  So the row is scanned
// once, plus k rescans of nx / blockDim slots.  Rows up to 57,856 values
// fit (dynamic shared memory above 48 KB is opted in at launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t TAKEN = 0xFFFFFFFFu;     // above every real key
constexpr uint32_t NAN_KEY = 0xFFFFFFFEu;   // above +inf, below TAKEN
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ uint32_t float_key(float v) {
    if (v != v) return NAN_KEY;
    if (v == 0.f) v = 0.f;                  // -0 ties with +0
    const uint32_t u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key, int i) {
    return (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ unsigned long long scan_min(const uint32_t* keys,
                                                       int nx) {
    unsigned long long best = NONE;
    for (int i = threadIdx.x; i < nx; i += THREADS) {
        const unsigned long long p = pack(keys[i], i);
        best = p < best ? p : best;
    }
    return best;
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ d, float* __restrict__ vals,
            int* __restrict__ idx, int nx, int k) {
    extern __shared__ __align__(16) uint32_t keys[];   // nx keys of this row
    __shared__ unsigned long long warp_best[THREADS / 32];
    __shared__ unsigned long long winner;

    const float* row = d + (size_t)blockIdx.x * nx;
    // stage the row: 16-byte loads where the row allows them, unrolled so
    // several loads per thread are in flight at once
    if (nx % 4 == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        uint4* keys4 = reinterpret_cast<uint4*>(keys);
#pragma unroll 4
        for (int i = threadIdx.x; i < nx / 4; i += THREADS) {
            const float4 v = row4[i];
            keys4[i] = make_uint4(float_key(v.x), float_key(v.y),
                                  float_key(v.z), float_key(v.w));
        }
    } else {
#pragma unroll 4
        for (int i = threadIdx.x; i < nx; i += THREADS) keys[i] = float_key(row[i]);
    }
    __syncthreads();

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    unsigned long long mine = scan_min(keys, nx);

    for (int j = 0; j < k; ++j) {
        unsigned long long b = mine;
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
            const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, b, off);
            b = o < b ? o : b;
        }
        if (lane == 0) warp_best[warp] = b;
        __syncthreads();
        if (warp == 0) {
            b = lane < THREADS / 32 ? warp_best[lane] : NONE;
#pragma unroll
            for (int off = 16; off > 0; off /= 2) {
                const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, b, off);
                b = o < b ? o : b;
            }
            if (lane == 0) {
                const int w = static_cast<int>(b & 0xFFFFFFFFu);
                vals[(size_t)blockIdx.x * k + j] = row[w];
                idx[(size_t)blockIdx.x * k + j] = w;
                keys[w] = TAKEN;
                winner = b;
            }
        }
        __syncthreads();
        // the owner rescans; winner and keys change again only after the
        // next round's first barrier, which every thread reaches after this
        if (mine == winner) mine = scan_min(keys, nx);
    }
}

}  // namespace

// d (nq, nx) fp32 row-major -> vals (nq, k) fp32, idx (nq, k) int32.
// Needs 1 <= k <= nx.  Returns cudaGetLastError() (0 = success).
extern "C" int topk_launch(const void* d, void* vals, void* idx, int nq,
                           int nx, int k, void* stream) {
    const size_t smem = (size_t)nx * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    topk_kernel<<<nq, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(d), static_cast<float*>(vals),
        static_cast<int*>(idx), nx, k);
    return static_cast<int>(cudaGetLastError());
}

// Largest nx a row may have: 227 KB of shared memory per block, less 1 KB
// kept for the kernel's static shared memory.
extern "C" int topk_max_nx() {
    return (232448 - 1024) / static_cast<int>(sizeof(uint32_t));
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
