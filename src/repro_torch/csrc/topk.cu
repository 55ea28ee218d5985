// k smallest per row for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk/topk.py::topk_smallest (the Pallas TPU
// kernel behind repro.kernels.topk.ops.topk_smallest).
//
//   vals[i, :] = the k smallest of d[i, :], ascending (fp32)
//   idx[i, :]  = their column indices (int32); ties go to the lowest index
//
// Semantics follow the plain version (a stable ascending sort cut at k),
// not the Pallas body, in one place: once a row runs out of values below
// BIG, the Pallas kernel picks the same lowest index again; here the k
// indices of a row are always distinct.  Each value has a 32-bit key whose
// unsigned order is the float order (-0 folded onto +0 so that they tie,
// NaN above +inf, as a stable sort places them), packed with its column
// into one 64-bit word.  The words of a row are distinct, so "the k
// smallest words, ascending" is exactly a stable sort cut at k; vals are
// read back from d at the chosen columns, so -0 stays -0.
//
// What bounds it on the H100: the bytes.  Each row is read once and k
// pairs are written; at the brute-force shape (64 x 8192, k = 10) that is
// 2.1 MB, 0.63 us at 3.35 TB/s.  With 64 rows the time is latency: the
// row's loads, then every step that depends on another.  So the select
// and the row sort keep that chain short: neither waits on a serial round.
//
// One launch per call, one of four kernels chosen on the host by k and nx:
//
// * 2 <= k <= K_WARP_MAX (256): the threshold select.  A row gets W warps
//   (a power of two, at most WARPS = 8, one per CHUNK = 1,024 values), a
//   block WARPS / W rows; a lane holds 32 values from 16-byte loads, in
//   registers.  Each warp bounds the k-th smallest from above without
//   sorting: with c = ceil(k / 32), the m = ceil(k / c)-th smallest of the
//   lanes' c-th smallest keys (a bitonic sort of 32 keys over shuffles;
//   for k <= 32 the lanes' minima); the row's bound is the least of its
//   warps'.  The candidates, gathered in shared memory by a warp scan and
//   the warps' totals, are the values at or below it: about k to 3k on
//   data without ties.  Where more than k values sit at the bound (a row
//   mostly at one value, as BIG is in a filtered search), only the k of
//   lowest column among them are taken, placed by ballots in column
//   order, so such a row gives k candidates, not a step.  Each candidate
//   then goes to its rank (the count of candidates below it), straight
//   into vals and idx.  Where more than two candidates a thread remain (a
//   large k), a bitonic sort in shared memory takes them, every
//   comparator putting the smaller word first (each merge begins with a
//   flip), so the padding to a power of two is virtual.  The row's warps meet at named barriers, so rows
//   of one block never wait on each other.  Rows longer than W * CHUNK go
//   in steps, the running k smallest kept in shared memory and taken as
//   candidates with the next step's values below its k-th word: no row
//   limit.
//
// * k = 1 (the k-means assignment): each lane's least value and its lowest
//   column, the warp's by two __reduce_min_sync, the row's across its
//   warps; no shared-memory stage, a quarter of the registers.
//
// * k > K_WARP_MAX, nx <= SORT_MAX_NX (the ivf all-cells probe: k = nx =
//   1,569): the row sort.  One block of 1,024 threads per row holds the
//   row's words in shared memory (224 KB at SORT_MAX_NX = 28,672) and
//   sorts them with the same virtually padded bitonic network.
//
// * k > K_WARP_MAX, nx > SORT_MAX_NX (a brute-force merge of 123 chunks at
//   k = 300, an all-cells probe over more than 28,672 cells): k rounds of
//   a block-wide argmin over the row's keys staged in shared memory, the
//   taken slot marked above every key.  Rows up to ROUND_MAX_NX = 57,856
//   fit (226 KB); kernels/topk/ops.py raises above that for this range
//   only.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

typedef unsigned long long u64;

constexpr int CHUNK = 1024;                 // values of a warp's step
constexpr int PER_LANE = CHUNK / 32;        // values a lane holds
constexpr int WARPS = 8;                    // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int K_WARP_MAX = 256;             // largest k of the threshold select
constexpr int SORT_THREADS = 1024;
constexpr int SORT_MAX_NX = 28672;          // 224 KB of 64-bit words
constexpr int ROUND_MAX_NX = 57856;         // 226 KB of 32-bit keys
constexpr uint32_t TAKEN = 0xFFFFFFFFu;     // above every real key
constexpr uint32_t NAN_KEY = 0xFFFFFFFEu;   // above +inf
constexpr uint32_t PAD_KEY = 0xFFFFFFFFu;   // no value
constexpr u64 NONE = ~0ull;                 // above every real word
static_assert(PER_LANE % 4 == 0, "a lane loads its values as float4");

__device__ __forceinline__ uint32_t float_key(float v) {
    if (v != v) return NAN_KEY;
    if (v == 0.f) v = 0.f;                  // -0 ties with +0
    const uint32_t u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float whose key is `key` (a real key below NAN_KEY).
__device__ __forceinline__ float key_float(uint32_t key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ u64 pack(float v, int i) {
    return (static_cast<u64>(float_key(v)) << 32) | static_cast<uint32_t>(i);
}

// Barrier of the nthreads threads of one row (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void row_sync(int id, int nthreads) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(nthreads) : "memory");
}

// Column of a lane's value s in a step starting at base: 16-byte loads
// take four neighbours a lane, scalar loads one.
template <bool VEC>
__device__ __forceinline__ int column(int base, int lane, int s) {
    return VEC ? base + 4 * (lane + 32 * (s / 4)) + s % 4
               : base + lane + 32 * s;
}

// A lane's values of the step at base (anything past nx is never read).
template <bool VEC>
__device__ __forceinline__ void load_step(float (&v)[PER_LANE], const float* r,
                                          int base, int nx, int lane) {
    if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < PER_LANE / 4; ++j) {
            const int i = base + 4 * (lane + 32 * j);
            if (i < nx) {   // nx % 4 == 0: the whole float4 lies in the row
                const float4 f = *reinterpret_cast<const float4*>(r + i);
                v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z,
                v[4 * j + 3] = f.w;
            }
        }
    } else {
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s) {
            const int i = base + lane + 32 * s;
            if (i < nx) v[s] = r[i];
        }
    }
}

// k = 1 (the k-means assignment): each lane's least value and its lowest
// column, the warp's by two min reductions, the row's across its W warps.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
topk_min_kernel(const float* __restrict__ d, float* __restrict__ vals,
                int* __restrict__ idx, int nq, int nx, int W) {
    __shared__ u64 best[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int slot = warp / W, part = warp % W;
    const int row = blockIdx.x * (WARPS / W) + slot;
    if (row >= nq) return;
    const float* r = d + (size_t)row * nx;
    u64 b = NONE;
    float v[PER_LANE];
    for (int base = part * CHUNK; base < nx; base += W * CHUNK) {
        load_step<VEC>(v, r, base, nx, lane);
        float lo = __int_as_float(0x7FC00000);          // NaN: no value yet
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s)
            if (column<VEC>(base, lane, s) < nx) lo = fminf(lo, v[s]);
        // the lowest column holding lo (-0 == +0; any, where all are NaN)
        int lc = INT_MAX;
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s) {
            const int col = column<VEC>(base, lane, s);
            if (col < nx && (v[s] == lo || lo != lo)) lc = min(lc, col);
        }
        if (lc != INT_MAX) {
            const u64 w = (static_cast<u64>(float_key(lo)) << 32)
                          | static_cast<uint32_t>(lc);
            b = w < b ? w : b;
        }
    }
    const uint32_t kmin = __reduce_min_sync(0xFFFFFFFFu, static_cast<uint32_t>(b >> 32));
    const uint32_t cmin = __reduce_min_sync(
        0xFFFFFFFFu, static_cast<uint32_t>(b >> 32) == kmin ? static_cast<uint32_t>(b)
                                                            : 0xFFFFFFFFu);
    b = (static_cast<u64>(kmin) << 32) | cmin;
    if (W > 1) {
        if (lane == 0) best[warp] = b;
        row_sync(1 + slot, 32 * W);
        for (int w = 0; w < W; ++w) {
            const u64 o = best[slot * W + w];
            b = o < b ? o : b;
        }
    }
    if (part == 0 && lane == 0) {
        const int col = static_cast<int>(static_cast<uint32_t>(b));
        vals[row] = r[col];
        idx[row] = col;
    }
}

// The threshold select.  A block of WARPS warps takes WARPS / W rows, W
// warps (a power of two) a row; a row's steps are W * CHUNK values.
// Shared memory per row: its running k smallest (k words), then its
// candidates (the running list's words and a step's: W * CHUNK + k).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
topk_select_kernel(const float* __restrict__ d, float* __restrict__ vals,
                   int* __restrict__ idx, int nq, int nx, int k, int W) {
    extern __shared__ u64 smem[];
    __shared__ uint32_t warp_bound[WARPS];
    __shared__ int warp_count[WARPS];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int slot = warp / W, part = warp % W;       // row of the block, warp of the row
    const int nt = 32 * W, t = part * 32 + lane;      // the row's threads, this one's
    const int row = blockIdx.x * (WARPS / W) + slot;
    if (row >= nq) return;                  // whole rows: no barrier waits on it
    const int bar = 1 + slot;
    const int cap = W * CHUNK + k;
    u64* R = smem + (size_t)slot * (k + cap);
    u64* cand = R + k;
    const float* r = d + (size_t)row * nx;
    float* vrow = vals + (size_t)row * k;
    int* irow = idx + (size_t)row * k;
    const int c = (k + 31) / 32, m = (k + c - 1) / c;

    int held = 0;                           // real words in R (0 or k)
    uint32_t tk = PAD_KEY, tc = 0;          // R's k-th word: key, column
    float v[PER_LANE];
    const int step = W * CHUNK;
    int base = part * CHUNK;
    for (int s0 = 0; s0 < nx; s0 += step, base += step) {
        load_step<VEC>(v, r, base, nx, lane);

        // the warp's bound: with c = ceil(k / 32), the m = ceil(k / c)-th
        // smallest of the lanes' c-th smallest distinct keys (m lanes hold
        // c values at or below it, m * c >= k); the row's is the least of
        // its warps', so every word of the step's k smallest is at or below
        uint32_t x;
        if (c == 1) {
            float lo = __int_as_float(0x7FC00000);      // NaN: no value yet
#pragma unroll
            for (int s = 0; s < PER_LANE; ++s)
                if (column<VEC>(base, lane, s) < nx) lo = fminf(lo, v[s]);
            const bool any = column<VEC>(base, lane, 0) < nx;
            x = any ? float_key(lo) : PAD_KEY;
        } else {
            x = 0;
            for (int p = 0; p < c; ++p) {
                uint32_t y = PAD_KEY;
#pragma unroll
                for (int s = 0; s < PER_LANE; ++s) {
                    const uint32_t kk = column<VEC>(base, lane, s) < nx
                        ? float_key(v[s]) : PAD_KEY;
                    y = (p == 0 || kk > x) ? min(y, kk) : y;
                }
                x = y;
            }
        }
        if (m == 1) {
            x = __reduce_min_sync(0xFFFFFFFFu, x);
        } else {                            // bitonic sort of the lanes' x
#pragma unroll
            for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
                for (int st = size >> 1; st > 0; st >>= 1) {
                    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, st);
                    x = (((lane & st) == 0) == ((lane & size) == 0))
                        ? min(x, y) : max(x, y);
                }
            x = __shfl_sync(0xFFFFFFFFu, x, m - 1);
        }
        if (lane == 0) warp_bound[warp] = x;
        row_sync(bar, nt);
        uint32_t bound = PAD_KEY;
        for (int w = 0; w < W; ++w) bound = min(bound, warp_bound[slot * W + w]);

        // candidates: R's words, the step's values below the bound, and
        // those at it; once R is full, only words below its k-th.  Bit s
        // of lt / eq: value s is below / at the bound.  The float compare
        // is the key compare (-0 == +0, NaN fails it) except where the
        // bound is NaN's key or no bound.
        const bool open = bound >= NAN_KEY;
        const float bf = open ? 0.f : key_float(bound);
        uint32_t lt = 0, eq = 0;
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s) {
            const int col = column<VEC>(base, lane, s);
            bool below = open ? (bound == PAD_KEY || v[s] == v[s]) : v[s] < bf;
            bool at = open ? !below : v[s] == bf;
            if (held) {
                const uint32_t kk = float_key(v[s]);
                const bool pass = kk < tk || (kk == tk && (uint32_t)col < tc);
                below = below && pass;
                at = at && pass;
            }
            lt |= (col < nx && below) ? 1u << s : 0u;
            eq |= (col < nx && at) ? 1u << s : 0u;
        }
        // one scan of both counts: (below) | (at) << 16
        const int cnt = __popc(lt) | __popc(eq) << 16;
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) warp_count[warp] = incl;
        for (int i = t; i < held; i += nt) cand[i] = R[i];
        row_sync(bar, nt);
        int off_lt = held, off = held, n_lt = held, tie = 0, n_eq = 0;
        for (int w = 0; w < W; ++w) {
            const int cw = warp_count[slot * W + w];
            off_lt += w < part ? cw & 0xFFFF : 0;
            off += w < part ? (cw & 0xFFFF) + (cw >> 16) : 0;
            tie += w < part ? cw >> 16 : 0;
            n_lt += cw & 0xFFFF;
            n_eq += cw >> 16;
        }
        const int excl = incl - cnt;
        if (n_eq <= k) {
            // every tie can be among the k smallest: all by the scan
            int pos = off + (excl & 0xFFFF) + (excl >> 16);
#pragma unroll
            for (int s = 0; s < PER_LANE; ++s)
                if ((lt | eq) >> s & 1)
                    cand[pos++] = pack(v[s], column<VEC>(base, lane, s));
        } else {
            // more ties than k (a row mostly at one value, as BIG is in a
            // filtered search): ties order by column, so only the k of
            // lowest column can be among the k smallest; they go after
            // the values below, ranked by ballots in column order (tie
            // counts those of lower columns so far)
            int pos = off_lt + (excl & 0xFFFF);
#pragma unroll
            for (int s = 0; s < PER_LANE; ++s)
                if (lt >> s & 1) cand[pos++] = pack(v[s], column<VEC>(base, lane, s));
            const uint32_t lower = (1u << lane) - 1;
            if constexpr (VEC) {            // column order: j, lane, s % 4
#pragma unroll
                for (int j = 0; j < PER_LANE / 4; ++j) {
                    uint32_t b[4];
                    int r = tie;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        b[q] = __ballot_sync(0xFFFFFFFFu, eq >> (4 * j + q) & 1);
                        r += __popc(b[q] & lower);
                    }
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        if (b[q] >> lane & 1) {
                            if (r < k)
                                cand[n_lt + r] = pack(
                                    v[4 * j + q], column<VEC>(base, lane, 4 * j + q));
                            ++r;
                        }
                        tie += __popc(b[q]);
                    }
                }
            } else {                        // column order: s, lane
#pragma unroll
                for (int s = 0; s < PER_LANE; ++s) {
                    const uint32_t bs = __ballot_sync(0xFFFFFFFFu, eq >> s & 1);
                    const int r = tie + __popc(bs & lower);
                    if ((bs >> lane & 1) && r < k)
                        cand[n_lt + r] = pack(v[s], column<VEC>(base, lane, s));
                    tie += __popc(bs);
                }
            }
        }
        const int n = n_lt + min(n_eq, k);
        row_sync(bar, nt);

        // the k smallest of the n candidates (n >= k: the bound is at or
        // above the step's k-th), into R, or vals and idx at the last step
        const bool last = s0 + step >= nx;
        if (n <= 2 * nt) {
            // by rank: a word's place is the count of words below it
            for (int j = t; j < n; j += nt) {
                const u64 w = cand[j];
                int p = 0;
#pragma unroll 8
                for (int q = 0; q < n; ++q) p += cand[q] < w;
                if (p < k) {
                    if (last) {
                        const int col = static_cast<int>(static_cast<uint32_t>(w));
                        vrow[p] = r[col];
                        irow[p] = col;
                    } else {
                        R[p] = w;
                    }
                }
            }
        } else {
            // many (ties at the bound, or a large k): a bitonic sort in
            // place, every comparator putting the smaller word first, so
            // the padding to a power of two is virtual
            int p2 = 1;
            while (p2 < n) p2 <<= 1;
            for (int size = 2; size <= p2; size <<= 1) {
                const int half = size >> 1;
                for (int u = t; u < p2 / 2; u += nt) {
                    const int blk = u / half, o = u % half;
                    const int i = blk * size + o, j = blk * size + size - 1 - o;
                    if (j < n && cand[j] < cand[i]) {
                        const u64 a = cand[i];
                        cand[i] = cand[j];
                        cand[j] = a;
                    }
                }
                row_sync(bar, nt);
                for (int st = half >> 1; st > 0; st >>= 1) {
                    for (int u = t; u < p2 / 2; u += nt) {
                        const int i = 2 * u - (u & (st - 1)), j = i + st;
                        if (j < n && cand[j] < cand[i]) {
                            const u64 a = cand[i];
                            cand[i] = cand[j];
                            cand[j] = a;
                        }
                    }
                    row_sync(bar, nt);
                }
            }
            for (int i = t; i < k; i += nt) {
                const u64 w = cand[i];
                if (last) {
                    const int col = static_cast<int>(static_cast<uint32_t>(w));
                    vrow[i] = r[col];
                    irow[i] = col;
                } else {
                    R[i] = w;
                }
            }
        }
        if (!last) {
            row_sync(bar, nt);
            held = k;
            const u64 kth = R[k - 1];
            tk = static_cast<uint32_t>(kth >> 32);
            tc = static_cast<uint32_t>(kth);
        }
    }
}

__device__ __forceinline__ void write_row(const u64* list, const float* row,
                                          float* vals, int* idx, int k) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const int c = static_cast<int>(static_cast<uint32_t>(list[i]));
        vals[i] = row[c];
        idx[i] = c;
    }
}

__global__ void __launch_bounds__(SORT_THREADS)
topk_sort_kernel(const float* __restrict__ d, float* __restrict__ vals,
                 int* __restrict__ idx, int nx, int k) {
    extern __shared__ u64 s[];              // the row's nx words
    const float* r = d + (size_t)blockIdx.x * nx;
    for (int i = threadIdx.x; i < nx; i += SORT_THREADS) s[i] = pack(r[i], i);
    __syncthreads();
    int p2 = 1;
    while (p2 < nx) p2 <<= 1;
    // every comparator puts the smaller word at the lower place, so the
    // virtual padding past nx (above every word) never moves
    for (int size = 2; size <= p2; size <<= 1) {
        const int half = size >> 1;
        for (int t = threadIdx.x; t < p2 / 2; t += SORT_THREADS) {
            const int blk = t / half, off = t % half;
            const int i = blk * size + off, j = blk * size + size - 1 - off;
            if (j < nx && s[j] < s[i]) {
                const u64 a = s[i];
                s[i] = s[j];
                s[j] = a;
            }
        }
        __syncthreads();
        for (int stride = half >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < p2 / 2; t += SORT_THREADS) {
                const int i = 2 * t - (t & (stride - 1)), j = i + stride;
                if (j < nx && s[j] < s[i]) {
                    const u64 a = s[i];
                    s[i] = s[j];
                    s[j] = a;
                }
            }
            __syncthreads();
        }
    }
    write_row(s, r, vals + (size_t)blockIdx.x * k, idx + (size_t)blockIdx.x * k, k);
}

// k > K_WARP_MAX on rows past SORT_MAX_NX: k rounds.  The block stages
// the row's keys in shared memory; each thread keeps the least word of its
// strided slots, a round reduces them across the block, writes the winner
// and marks its slot taken, and only the thread that held it rescans.
__global__ void __launch_bounds__(THREADS)
topk_rounds_kernel(const float* __restrict__ d, float* __restrict__ vals,
                   int* __restrict__ idx, int nx, int k) {
    extern __shared__ uint32_t keys[];      // the row's nx keys
    __shared__ u64 warp_best[WARPS];
    __shared__ u64 winner;
    const float* r = d + (size_t)blockIdx.x * nx;
    for (int i = threadIdx.x; i < nx; i += THREADS) keys[i] = float_key(r[i]);
    __syncthreads();
    auto scan_min = [&]() {
        u64 b = NONE;
        for (int i = threadIdx.x; i < nx; i += THREADS) {
            const u64 w = (static_cast<u64>(keys[i]) << 32) | static_cast<uint32_t>(i);
            b = w < b ? w : b;
        }
        return b;
    };
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    u64 mine = scan_min();
    for (int j = 0; j < k; ++j) {
        u64 b = mine;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const u64 y = __shfl_down_sync(0xFFFFFFFFu, b, o);
            b = y < b ? y : b;
        }
        if (lane == 0) warp_best[warp] = b;
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < WARPS; ++w) b = warp_best[w] < b ? warp_best[w] : b;
            const int col = static_cast<int>(static_cast<uint32_t>(b));
            vals[(size_t)blockIdx.x * k + j] = r[col];
            idx[(size_t)blockIdx.x * k + j] = col;
            keys[col] = TAKEN;
            winner = b;
        }
        __syncthreads();
        // winner and keys change again only after the next round's first
        // barrier, which every thread reaches after this
        if (mine == winner) mine = scan_min();
    }
}

// Opt fn into `bytes` of dynamic shared memory, once per device.
cudaError_t opt_in(const void* fn, int bytes, int variant) {
    static int done[4][64];                 // bytes set, by variant and device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int& have = done[variant][dev & 63];
    if (have >= bytes) return cudaSuccess;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) have = bytes;
    return e;
}

}  // namespace

// d (nq, nx) fp32 row-major -> vals (nq, k) fp32, idx (nq, k) int32.
// Needs 1 <= k <= nx, and nx <= ROUND_MAX_NX where k > K_WARP_MAX.
// Returns cudaGetLastError() (0 = success).
extern "C" int topk_launch(const void* d, void* vals, void* idx, int nq,
                           int nx, int k, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* dp = static_cast<const float*>(d);
    float* vp = static_cast<float*>(vals);
    int* ip = static_cast<int*>(idx);
    if (k > K_WARP_MAX && nx > SORT_MAX_NX) {
        if (nx > ROUND_MAX_NX) return static_cast<int>(cudaErrorInvalidValue);
        const cudaError_t opted = opt_in(
            (const void*)topk_rounds_kernel,
            ROUND_MAX_NX * static_cast<int>(sizeof(uint32_t)), 3);
        if (opted != cudaSuccess) return static_cast<int>(opted);
        topk_rounds_kernel<<<nq, THREADS, (size_t)nx * sizeof(uint32_t), st>>>(
            dp, vp, ip, nx, k);
        return static_cast<int>(cudaGetLastError());
    }
    if (k > K_WARP_MAX) {
        const cudaError_t opted = opt_in(
            (const void*)topk_sort_kernel,
            SORT_MAX_NX * static_cast<int>(sizeof(u64)), 2);
        if (opted != cudaSuccess) return static_cast<int>(opted);
        topk_sort_kernel<<<nq, SORT_THREADS, (size_t)nx * sizeof(u64), st>>>(
            dp, vp, ip, nx, k);
        return static_cast<int>(cudaGetLastError());
    }
    // warps a row: a power of two, at most WARPS, at least a step each
    int W = 1;
    while (W < WARPS && (long long)W * CHUNK < nx) W *= 2;
    const int rows = WARPS / W;
    const unsigned blocks = (unsigned)((nq + rows - 1) / rows);
    const bool vec = nx % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
    if (k == 1) {
        if (vec)
            topk_min_kernel<true><<<blocks, THREADS, 0, st>>>(dp, vp, ip, nq, nx, W);
        else
            topk_min_kernel<false><<<blocks, THREADS, 0, st>>>(dp, vp, ip, nq, nx, W);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem = sizeof(u64) * (size_t)rows * (k + W * CHUNK + k);
    const void* fn = vec ? (const void*)topk_select_kernel<true>
                         : (const void*)topk_select_kernel<false>;
    const cudaError_t opted = opt_in(fn, static_cast<int>(smem), vec ? 1 : 0);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    if (vec)
        topk_select_kernel<true><<<blocks, THREADS, smem, st>>>(dp, vp, ip, nq, nx, k, W);
    else
        topk_select_kernel<false><<<blocks, THREADS, smem, st>>>(dp, vp, ip, nq, nx, k, W);
    return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned above.
extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
