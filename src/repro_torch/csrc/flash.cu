// Causal GQA flash-attention forward for Hopper (sm_90a), both products in
// 3xTF32 on the tensor cores.
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
// (the causal triangle), so the byte bound (0.77 us at 3.35 TB/s) is far
// above the operation bound, even at three TF32 passes; a launch and one
// round trip to memory cost more than either.  With 16 rows a warp the
// prefill runs one warp on most SM sub-partitions, so every instruction's
// latency is exposed: the design is about latency and filling the card.
//
// Design: rows are folded as in the Pallas kernel: folded row f of kv head
// hk is query position f / G of query head hk * G + f % G, so a kv tile
// staged in shared memory serves all G heads of its group.  A block owns
// 16 W consecutive folded rows (W = 1, 2 or 4 warps, chosen at launch: the
// widest that still gives at least one block per SM and at most 15 dead
// rows in the last tile; the prefill shape launches 216 blocks of one
// warp, S 128 144 blocks of four).  Each warp owns 16 rows, the m16 of an
// m16n8k8 fragment: its q rows are read once from memory into A fragments
// (split into TF32 hi and lo there for D <= 64; above that kept in shared
// memory and split as they are read, to spare registers).  Keys come in tiles of 32, staged by
// 16-byte cp.async copies into a 2-stage ring (the next tile's copy
// overlaps this tile's products); K and V rows are padded by 4 floats (a
// stride of 4 mod 8), so the ldmatrix reads of K and the scalar reads of
// V are conflict-free.  Per tile, per warp: S = Q K^T in 3xTF32 mma.sync,
// pass by pass over the 4 key groups; the row max over the 4 lanes of a
// row with 2 shuffles (each lane keeps its own partial row sum, summed
// over the quad once at the end); p = exp2((s - m) log2 e); then P V in
// 3xTF32, with P fed from registers: the C fragment of S holds keys
// (2t, 2t + 1) where the A fragment wants (t, t + 4), so the k index of P
// and of the V fragment is permuted alike (k = t <-> key 2t, k = t + 4 <->
// key 2t + 1; tf32x3.cuh) and no value moves between lanes.  The output
// is scaled by one reciprocal of each row's sum (32 divisions a lane sit
// on the prefill's critical path).  kv tiles wholly above the diagonal or
// below the window band of a block are not staged; those of a warp's rows
// are not computed.  The heaviest tiles (the last positions) are launched
// first.
//
// Alignment: the cp.async variant needs fp32 K and V whose strides and D
// are multiples of 4 floats on 16-byte aligned pointers; anything else
// (ragged D such as 25, a view offset by one float, bf16, widened as it is
// staged) stages with 4-byte loads.  Both are the kernel.  Ragged S and D
// are masked in the loads and stores; nothing is padded on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int BK = 32;                     // keys per kv tile
constexpr int MAX_WARPS = 4;
constexpr float NEG_INF = -1073741824.f;   // -2^30, as the reference
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared row stride of a K, V or q tile: D padded to DP (a multiple of 8),
// plus 4, so that rows stay 16-byte aligned and the stride is 4 mod 8.
// Shared memory: 2 stages of (K, V) and, for D > 64, each warp's q rows.
template <int ND>
struct Tile {
    static constexpr int LD = 8 * ND + 4;
    static constexpr bool Q_IN_SMEM = ND > 8;
    static constexpr size_t SMEM = sizeof(float) * LD *
        (2 * 2 * BK + (Q_IN_SMEM ? MAX_WARPS * 16 : 0));
};

// Stage keys [k0, k0 + BK) of K and V into Ks, Vs; columns >= D and keys
// >= S are zero (a zero V row meets p = 0; uninitialised shared memory
// could hold NaN bits).
template <typename T, int ND, bool ASYNC>
__device__ __forceinline__ void stage(float* Ks, float* Vs, const T* kb,
                                      const T* vb, long long kss,
                                      long long vss, int k0, int S, int D,
                                      int tid, int nthreads) {
    constexpr int DP = 8 * ND, LD = Tile<ND>::LD;
    constexpr int CPR = DP / 4;            // 16-byte chunks per row
    if constexpr (ASYNC && 32 % CPR == 0) {
        // a thread keeps one column and steps down the rows (block sizes
        // are whole warps, so nthreads % CPR == 0)
        const int c = (tid % CPR) * 4;
        const bool col_ok = c < D;
        for (int j = tid / CPR; j < BK; j += nthreads / CPR) {
            const int kp = k0 + j;
            const bool ok = col_ok && kp < S;
            tf32x3::cp_async16(Ks + j * LD + c, ok ? kb + kp * kss + c : kb, ok);
            tf32x3::cp_async16(Vs + j * LD + c, ok ? vb + kp * vss + c : vb, ok);
        }
    } else if constexpr (ASYNC) {
        for (int e = tid; e < BK * CPR; e += nthreads) {
            const int j = e / CPR, c = (e % CPR) * 4;
            const int kp = k0 + j;
            const bool ok = kp < S && c < D;
            tf32x3::cp_async16(Ks + j * LD + c, ok ? kb + kp * kss + c : kb, ok);
            tf32x3::cp_async16(Vs + j * LD + c, ok ? vb + kp * vss + c : vb, ok);
        }
    } else {
        for (int e = tid; e < BK * DP; e += nthreads) {
            const int j = e / DP, c = e % DP;
            const int kp = k0 + j;
            const bool ok = kp < S && c < D;
            Ks[j * LD + c] = ok ? to_f32(kb[kp * kss + c]) : 0.f;
            Vs[j * LD + c] = ok ? to_f32(vb[kp * vss + c]) : 0.f;
        }
    }
}

// ND = head dim in chunks of 8, rounded up to 4, 8, 12 or 16 (D <= 32, 64,
// 96, 128); the chunks past D are zero in q, K and V.
template <typename T, int ND, bool ASYNC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int S, int Hk, int G, int D, int tiles,
             float q_scale, int window, float softcap) {
    constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
    // q's A fragments stay in registers as hi and lo for D <= 64; above
    // that q's rows go to shared memory and are split as they are read
    constexpr bool QSPLIT = !Tile<ND>::Q_IN_SMEM;
    constexpr int LD = Tile<ND>::LD;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                      // [2][BK][LD]
    float* Vs = smem + 2 * BK * LD;        // [2][BK][LD]

    const int nthreads = blockDim.x, W = nthreads >> 5;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / Hk, hk = blockIdx.y % Hk;
    const int R = S * G;                           // folded rows of (b, hk)
    const int f0 = (tiles - 1 - (int)blockIdx.x) * 16 * W;   // heaviest first
    const int pos_first = f0 / G;
    const int pos_last = (min(R, f0 + 16 * W) - 1) / G;
    const int Hq = Hk * G;

    // this warp's rows, and this lane's two of them (g and g + 8)
    const int wf0 = f0 + warp * 16;
    const bool warp_live = wf0 < R;
    const int wpos0 = wf0 / G, wpos1 = (min(R, wf0 + 16) - 1) / G;
    // keys in [key_lo, key_hi] are in the band of row h (none for a dead row)
    int pos[2], head[2], key_lo[2], key_hi[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int f = wf0 + g + 8 * h;
        live[h] = f < R;
        pos[h] = f / G;
        head[h] = f % G;
        key_hi[h] = live[h] ? min(pos[h], S - 1) : -1;
        key_lo[h] = window > 0 ? pos[h] - window + 1 : 0;
    }

    const T* kb = k + b * ksb + hk * ksh;
    const T* vb = v + b * vsb + hk * vsh;
    int k_lo = window > 0 ? max(0, pos_first - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int kv_tiles = (pos_last - k_lo) / BK + 1;

    stage<T, ND, ASYNC>(Ks, Vs, kb, vb, kss, vss, k_lo, S, D, tid, nthreads);
    tf32x3::cp_async_commit();

    // q rows g and g + 8 into A fragments (chunk c holds d = 8c + t, + 4),
    // or into this warp's 16 rows of shared memory
    float qf[ND][4];
    float* const Qw = smem + 4 * BK * LD + warp * 16 * LD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const T* qr = q + b * qsb + (long long)pos[h] * qss
                      + (long long)(hk * G + head[h]) * qsh;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
            const int d0 = 8 * c + t, d1 = d0 + 4;
            const float v0 = (live[h] && d0 < D) ? to_f32(qr[d0]) : 0.f;
            const float v1 = (live[h] && d1 < D) ? to_f32(qr[d1]) : 0.f;
            if constexpr (QSPLIT) {
                qf[c][h] = v0;
                qf[c][h + 2] = v1;
            } else {
                Qw[(g + 8 * h) * LD + d0] = v0;
                Qw[(g + 8 * h) * LD + d1] = v1;
            }
        }
    }
    __syncwarp();
    uint32_t qh[QSPLIT ? ND : 1][4], ql[QSPLIT ? ND : 1][4];
    if constexpr (QSPLIT) {
#pragma unroll
        for (int c = 0; c < ND; ++c) tf32x3::split(qf[c], qh[c], ql[c]);
    }

    // C fragments over d, in groups of 4: o[n / 4][n % 4] holds 8n + 2t, + 1
    float o[ND / 4][4][4];
#pragma unroll
    for (int n4 = 0; n4 < ND / 4; ++n4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n4][u][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};               // this lane's part of the row sums

    for (int it = 0; it < kv_tiles; ++it) {
        const int k0 = k_lo + it * BK;
        // tile it has landed; every warp is past tile it - 1, whose buffer
        // the next copy overwrites
        tf32x3::cp_async_wait<0>();
        __syncthreads();
        if (it + 1 < kv_tiles)
            stage<T, ND, ASYNC>(Ks + ((it + 1) & 1) * BK * LD,
                                Vs + ((it + 1) & 1) * BK * LD, kb, vb, kss,
                                vss, k0 + BK, S, D, tid, nthreads);
        tf32x3::cp_async_commit();
        if (!warp_live || k0 > wpos1 ||
            (window > 0 && k0 + BK - 1 <= wpos0 - window))
            continue;                      // no key of this tile is in band
        const float* Kt = Ks + (it & 1) * BK * LD;
        const float* Vt = Vs + (it & 1) * BK * LD;

        // S = Q K^T: 4 n-tiles of 8 keys
        float s[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
            uint32_t ah[4], al[4], kh[4][2], kl[4][2];
            if constexpr (QSPLIT) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    ah[e] = qh[c][e];
                    al[e] = ql[c][e];
                }
            } else {
                uint32_t af[4];
                tf32x3::ldmatrix_a(af, Qw + 8 * c, LD, lane);
                tf32x3::split(af, ah, al);
            }
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
                uint32_t kf[4], h[4], l[4];
                tf32x3::ldmatrix_b2(kf, Kt + 8 * j * LD + 8 * c, LD, lane);
                tf32x3::split(kf, h, l);
                kh[j][0] = h[0], kh[j][1] = h[1], kh[j + 1][0] = h[2], kh[j + 1][1] = h[3];
                kl[j][0] = l[0], kl[j][1] = l[1], kl[j + 1][0] = l[2], kl[j + 1][1] = l[3];
            }
            tf32x3::mma3_row<EXACT, EXACT>(s, ah, al, kh, kl);
        }

        // scale, cap, mask; the row max over the quad of lanes of a row
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1;
                const int kp = k0 + 8 * j + 2 * t + (e & 1);
                float x = s[j][e] * q_scale;
                if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                const bool ok = kp <= key_hi[h] && kp >= key_lo[h];
                s[j][e] = ok ? x : NEG_INF;
                mx[h] = fmaxf(mx[h], s[j][e]);
            }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
            alpha[h] = exp2f((m[h] - mx[h]) * LOG2E);
            m[h] = mx[h];
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = exp2f((s[j][e] - m[e >> 1]) * LOG2E);
                l[e >> 1] += s[j][e];
            }
#pragma unroll
        for (int n4 = 0; n4 < ND / 4; ++n4)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                o[n4][u][0] *= alpha[0];
                o[n4][u][1] *= alpha[0];
                o[n4][u][2] *= alpha[1];
                o[n4][u][3] *= alpha[1];
            }

        // O += P V: k-chunk j is S's n-tile j, keys permuted (2t, 2t + 1);
        // d in groups of 4 n-tiles
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float pf[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
            uint32_t ph[4], pl[4];
            tf32x3::split(pf, ph, pl);
            const float* v0 = Vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
            for (int n4 = 0; n4 < ND / 4; ++n4) {
                uint32_t vh[4][2], vl[4][2];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int n = 4 * n4 + u;
                    const float vf[2] = {v0[8 * n], v0[LD + 8 * n]};
                    tf32x3::split(vf, vh[u], vl[u]);
                }
                tf32x3::mma3_row<false, EXACT>(o[n4], ph, pl, vh, vl);
            }
        }
    }

    const bool pairs = (D & 1) == 0;       // 2-element stores stay aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float lt = l[h] + __shfl_xor_sync(FULL, l[h], 1);
        lt += __shfl_xor_sync(FULL, lt, 2);
        if (!live[h]) continue;
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        T* op = out + (((long long)b * S + pos[h]) * Hq + hk * G + head[h]) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const int d = 8 * n + 2 * t;
            if (d >= D) break;
            const float a = o[n / 4][n % 4][2 * h] * inv;
            const float c = o[n / 4][n % 4][2 * h + 1] * inv;
            if (pairs) {
                store2(op + d, a, c);
            } else {
                store1(op + d, a);
                if (d + 1 < D) store1(op + d + 1, c);
            }
        }
    }
}

template <typename T, int ND, bool ASYNC>
int launch(const void* q, const void* k, const void* v, void* out,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh,
           int B, int S, int Hk, int G, int D,
           float q_scale, int window, float softcap, cudaStream_t stream) {
    // The attribute belongs to the kernel, so it is set once per
    // instantiation; its error is kept.
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<T, ND, ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<ND>::SMEM);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    // the widest block (in warps of 16 folded rows) that still launches a
    // block per SM and leaves at most 15 dead rows in the last tile
    const int R = S * G, heads = B * Hk;
    int W = 1;
    for (int w = MAX_WARPS; w > 1; w >>= 1) {
        const int n = (R + 16 * w - 1) / (16 * w);
        if ((long long)n * heads >= tf32x3::sm_count() && n * 16 * w - R <= 15) {
            W = w;
            break;
        }
    }
    const int tiles = (R + 16 * W - 1) / (16 * W);
    const dim3 grid(tiles, heads);
    flash_kernel<T, ND, ASYNC><<<grid, 32 * W, Tile<ND>::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
        S, Hk, G, D, tiles, q_scale, window, softcap);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ASYNC>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh,
             int B, int S, int Hk, int G, int D,
             float q_scale, int window, float softcap, cudaStream_t s) {
#define FLASH_ARGS q, k, v, out, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, \
                   B, S, Hk, G, D, q_scale, window, softcap, s
    switch ((D + 31) / 32) {
        case 1: return launch<T, 4, ASYNC>(FLASH_ARGS);
        case 2: return launch<T, 8, ASYNC>(FLASH_ARGS);
        case 3: return launch<T, 12, ASYNC>(FLASH_ARGS);
        case 4: return launch<T, 16, ASYNC>(FLASH_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_ARGS
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Strides are in elements, for the batch, sequence and head dimensions of
// q, k and v.  Needs 1 <= D <= 128, G = Hq / Hk in 1..64.  dtype: 0 = fp32,
// 1 = bf16 (q, k, v and out all of it).  fp32 K and V whose D and strides
// are multiples of 4 on 16-byte aligned pointers stage with cp.async,
// everything else with 4-byte loads.  Returns cudaGetLastError() after the
// launch, or the error of the shared-memory attribute call, made at the
// first launch of each variant (0 = success).
extern "C" int flash_launch(const void* q, const void* k, const void* v,
                            void* out,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            int B, int S, int Hq, int Hk, int D,
                            float q_scale, int window, float softcap,
                            int dtype, void* stream) {
    if (Hk <= 0 || Hq % Hk != 0 || Hq / Hk > 64 || D < 1 || D > 128)
        return static_cast<int>(cudaErrorInvalidValue);
    const int G = Hq / Hk;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, \
                   B, S, Hk, G, D, q_scale, window, softcap, s
    if (dtype != 0) return launch_d<__nv_bfloat16, false>(FLASH_ARGS);
    const bool aligned = D % 4 == 0 && aligned16(k) && aligned16(v) &&
                         (ksb | kss | ksh | vsb | vss | vsh) % 4 == 0;
    return aligned ? launch_d<float, true>(FLASH_ARGS)
                   : launch_d<float, false>(FLASH_ARGS);
#undef FLASH_ARGS
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
