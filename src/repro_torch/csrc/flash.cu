// Causal GQA flash-attention forward for Hopper (sm_90a), fp32 on the CUDA
// cores.
//
// Replaces: src/repro/kernels/flash/flash.py::flash_attention and its
// (B, S, Hq, D) wrapper src/repro/kernels/flash/ops.py::causal_attention
// (the Pallas TPU kernel of the policy LM's attention).
//
//   s[i, j] = (q_i . k_j) * q_scale, then tanh(s / softcap) * softcap if
//             softcap > 0; masked to NEG_INF = -2^30 (finite) unless
//             j <= i and, for window > 0, j > i - window
//   out_i   = sum_j softmax(s_i)_j v_j, an online softmax in fp32 over kv
//             tiles, divided by max(l, 1e-30) and cast to the input dtype
//
// q is (B, S, Hq, D), k and v are (B, S, Hk, D), fp32 or bf16, read in
// place through their strides (the last dimension must be contiguous);
// out is a contiguous (B, S, Hq, D) tensor of the input dtype.  G = Hq / Hk
// query heads share one kv head (GQA), D <= 128, any S.
//
// What bounds it on the H100: at the policy LM's prefill shape
// (B 6, S 35, 12 heads of 64) the call moves 2.6 MB and does 11.6 MFLOP
// (the causal triangle), so the byte bound (0.77 us at 3.35 TB/s) is above
// the operation bound (0.17 us at 67 TFLOP/s fp32); a launch costs more
// than either.  At long S
// the work grows as S^2 and the operations bound it.
//
// Design (simple and right first; wgmma and TMA are for a later version):
// one block of 8 warps per (tile of 64 folded rows, batch x kv head).  The
// rows fold the group into the tile as the Pallas kernel does: row r is
// query position q0 + r / G of query head hk * G + r % G, so a tile covers
// 64 / G positions and every kv tile staged in shared memory serves all G
// heads of its group.  Each warp owns 8 rows with their m, l and acc in
// registers.  Per kv tile of 64 keys: each lane computes the scores of keys
// lane and lane + 32 for its warp's 8 rows (q rows broadcast from shared
// memory, k rows padded by 4 floats so the float4 reads spread over the
// banks), the warp reduces the row max and sum with shuffles, writes its
// probabilities to shared memory, then each lane accumulates the columns
// d = lane + 32 i of p . V.  kv tiles wholly above the diagonal or below the
// window band are never visited.  Ragged S and D are masked in the loads
// and the stores; nothing is padded on the host.  Shared memory is dynamic
// (116 KB at D = 128, above the 48 KB static limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // folded rows per block
constexpr int BK = 64;                 // keys per kv tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int R = BM / WARPS;          // rows per warp
constexpr float NEG_INF = -1073741824.f;   // -2^30, as the reference
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    return x;
}

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// NI = ceil(D / 32): the output columns each lane owns (d = lane + 32 i).
template <typename T, int NI>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int S, int Hk, int G, int D, int bq,
             float q_scale, int window, float softcap) {
    extern __shared__ __align__(16) float smem[];
    const int Dp = pad4(D);
    const int QST = Dp, KST = Dp + 4, VST = NI * 32;
    float* Qs = smem;                  // [BM][QST]
    float* Ks = Qs + BM * QST;         // [BK][KST]
    float* Vs = Ks + BK * KST;         // [BK][VST]
    float* Ps = Vs + BK * VST;         // [BM][BK]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
    const int q0 = blockIdx.x * bq;            // first query position
    const int rows = bq * G;                   // live rows of this tile
    const int q_last = min(S - 1, q0 + bq - 1);
    const int Hq = Hk * G;

    const T* qb = q + b * qsb + (long long)hk * G * qsh;
    const T* kb = k + b * ksb + hk * ksh;
    const T* vb = v + b * vsb + hk * vsh;

    for (int e = tid; e < BM * QST; e += THREADS) {
        const int r = e / QST, d = e % QST;
        const int pos = q0 + r / G;
        float x = 0.f;
        if (r < rows && pos < S && d < D)
            x = to_f32(qb[(long long)pos * qss + (long long)(r % G) * qsh + d]);
        Qs[e] = x;
    }

    float m[R], l[R], acc[R][NI];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
    }
    const int row0 = warp * R;

    // the first kv tile holding a key inside the band of the first row
    int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    for (int k0 = k_lo; k0 <= q_last; k0 += BK) {
        __syncthreads();               // every warp is done with the last tile
        for (int e = tid; e < BK * KST; e += THREADS) {
            const int j = e / KST, d = e % KST, kp = k0 + j;
            Ks[e] = (kp < S && d < D) ? to_f32(kb[(long long)kp * kss + d]) : 0.f;
        }
        for (int e = tid; e < BK * VST; e += THREADS) {
            const int j = e / VST, d = e % VST, kp = k0 + j;
            Vs[e] = (kp < S && d < D) ? to_f32(vb[(long long)kp * vss + d]) : 0.f;
        }
        __syncthreads();

        // scores of keys lane and lane + 32 for this warp's rows
        float s[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = 0.f;
        const float* ka_row = Ks + lane * KST;
        const float* kb_row = Ks + (lane + 32) * KST;
        for (int d = 0; d < Dp; d += 4) {
            const float4 ka = *reinterpret_cast<const float4*>(ka_row + d);
            const float4 kc = *reinterpret_cast<const float4*>(kb_row + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(Qs + (row0 + r) * QST + d);
                s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
                s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
                s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
                s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
                s[r][1] = fmaf(qv.x, kc.x, s[r][1]);
                s[r][1] = fmaf(qv.y, kc.y, s[r][1]);
                s[r][1] = fmaf(qv.z, kc.z, s[r][1]);
                s[r][1] = fmaf(qv.w, kc.w, s[r][1]);
            }
        }

        // online softmax, one row at a time across the warp
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int row = row0 + r;
            const int qp = q0 + row / G;
            float x[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int kp = k0 + lane + 32 * c;
                float t = s[r][c] * q_scale;
                if (softcap > 0.f) t = tanhf(t / softcap) * softcap;
                const bool ok = kp <= qp && kp < S &&
                                (window <= 0 || kp > qp - window);
                x[c] = ok ? t : NEG_INF;
            }
            const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
            const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
            const float alpha = expf(m[r] - m_new);
            l[r] = l[r] * alpha + warp_sum(p0 + p1);
#pragma unroll
            for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
            m[r] = m_new;
            Ps[row * BK + lane] = p0;
            Ps[row * BK + lane + 32] = p1;
        }
        __syncwarp();

        // acc[r][d] += sum_j p[r][j] * V[j][d] over this lane's columns
        const float* pr = Ps + row0 * BK;
        for (int j = 0; j < BK; j += 4) {
            float vv[4][NI];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
                for (int i = 0; i < NI; ++i)
                    vv[t][i] = Vs[(j + t) * VST + lane + 32 * i];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float4 p4 = *reinterpret_cast<const float4*>(pr + r * BK + j);
#pragma unroll
                for (int i = 0; i < NI; ++i) {
                    float a = acc[r][i];
                    a = fmaf(p4.x, vv[0][i], a);
                    a = fmaf(p4.y, vv[1][i], a);
                    a = fmaf(p4.z, vv[2][i], a);
                    a = fmaf(p4.w, vv[3][i], a);
                    acc[r][i] = a;
                }
            }
        }
        __syncwarp();
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        const int pos = q0 + row / G;
        if (row >= rows || pos >= S) continue;
        const float den = fmaxf(l[r], 1e-30f);
        T* op = out + (((long long)b * S + pos) * Hq + hk * G + row % G) * D;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            const int d = lane + 32 * i;
            if (d < D) store(op + d, acc[r][i] / den);
        }
    }
}

// Dynamic shared memory of one CTA: the q block, a K tile, a V tile and
// the score block, all fp32 (Dp is D rounded up to 4).
template <int NI>
size_t smem_bytes(int Dp) {
    return sizeof(float) * ((size_t)BM * Dp + (size_t)BK * (Dp + 4) +
                            (size_t)BK * NI * 32 + (size_t)BM * BK);
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* out,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh,
           int B, int S, int Hk, int G, int D,
           float q_scale, int window, float softcap, cudaStream_t stream) {
    // The attribute belongs to the kernel, so it is set once per
    // instantiation, to what its widest D needs; its error is kept.
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<T, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<NI>(NI * 32));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t smem = smem_bytes<NI>(pad4(D));
    const int bq = BM / G;
    const dim3 grid((S + bq - 1) / bq, B * Hk);
    flash_kernel<T, NI><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
        S, Hk, G, D, bq, q_scale, window, softcap);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int B, int S, int Hk, int G, int D,
             float q_scale, int window, float softcap, cudaStream_t s) {
#define FLASH_ARGS q, k, v, out, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, \
                   B, S, Hk, G, D, q_scale, window, softcap, s
    switch ((D + 31) / 32) {
        case 1: return launch<T, 1>(FLASH_ARGS);
        case 2: return launch<T, 2>(FLASH_ARGS);
        case 3: return launch<T, 3>(FLASH_ARGS);
        case 4: return launch<T, 4>(FLASH_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_ARGS
}

}  // namespace

// Strides are in elements, for the batch, sequence and head dimensions of
// q, k and v.  Needs 1 <= D <= 128, G = Hq / Hk in 1..64.  dtype: 0 = fp32,
// 1 = bf16 (q, k, v and out all of it).  Returns cudaGetLastError() after
// the launch, or the error of the shared-memory attribute call, made at the
// first launch of each dtype and D range (0 = success).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            int B, int S, int Hq, int Hk, int D,
                            float q_scale, int window, float softcap,
                            int dtype, void* stream) {
    if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > BM || D < 1 || D > 128)
        return static_cast<int>(cudaErrorInvalidValue);
    const int G = Hq / Hk;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_d<float>(q, k, v, out, qsb, qss, qsh, ksb, kss, ksh,
                               vsb, vss, vsh, B, S, Hk, G, D, q_scale,
                               window, softcap, s);
    return launch_d<__nv_bfloat16>(q, k, v, out, qsb, qss, qsh, ksb, kss, ksh,
                                   vsb, vss, vsh, B, S, Hk, G, D, q_scale,
                                   window, softcap, s);
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
