// Alignment rows from the row traceback's records (K2e), for Hopper.
//
// Replaces host numpy: hinge_tpu/ops/pallas_band_nw.py::_emit_rowrec, which
// turns K2's per-row records into gapped rows on the host.  It has no TPU
// kernel; the plain torch twin is
// hinge_tpu_torch/ops/band_nw.py::emit_rows_ref, and the rows are
// bit-identical to both.
//
// A window of m query rows, with K2's cnt[r] (left columns after row r's
// up/diag column, uint8), mv0[r] (that column's move, 1 = up) and j_rem
// (leading left columns), has cols = j_rem + m + sum(cnt[:m]) columns:
//   column of row r:  c_r = j_rem + r + sum(cnt[<r])   q[r] there
//   q row:            GAP (4) in every other column
//   t row:            GAP in c_r where mv0[r] == 1; t's bases fill every
//                     other column in order, so column x (not an up column)
//                     holds t[x - (up columns before x)]
// The windows' rows lie end to end: q rows at [0, total), t rows at
// [total, 2 total), window w at base[w] = sum(cols[<w]) in each.  A window
// whose records do not fit its lengths (cols - ups != n, j_rem < 0, m
// outside [0, mrows], bases outside the flat buffers) gets no columns and
// is counted in meta[B + 1]; K2's records of a band fill never do that.
//
// What bounds it on this card: bytes.  Per window it reads m bytes each of
// cnt, mv0 and q, n bytes of t and 12 bytes of lengths, and writes 2 cols
// bytes; next to that its operations (a scan over the rows, a few adds a
// column) are few.
// What the design does about it, in three launches on the stream, with no
// host synchronisation between them:
// - `emit_count_kernel`, a warp a window: cols and the fit test, the rows'
//   bytes read coalesced.
// - `emit_scan_kernel`, one block: exclusive scans over the windows of m,
//   n (where each window's bases lie in the flat q and t) and cols (its
//   base in the rows), in chunks of 1,024 windows with a carry.
// - `emit_rows_kernel`, a block a window, ITEMS consecutive rows a thread:
//   one block-wide exclusive scan of (cnt + 1, mv0 == 1) packed in 64 bits
//   gives each row its column and the up columns before it; each thread
//   then writes its rows' columns (the up/diag column and the cnt left
//   ones) into shared memory, each column by exactly one thread, so
//   nothing is filled twice.  The staged rows go out as 16-byte stores:
//   the stage is shifted to the destination's alignment mod 16, so only
//   the ragged ends are byte stores.  Windows longer than the stage
//   (chunks of threads x ITEMS rows whose columns exceed it) write the
//   same columns straight to device memory.  The launch shape (threads a
//   window, stage bytes) comes from the block's longest window
//   (band_nw.emit_plan).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t GAP = 4;
constexpr int ITEMS = 4;            // consecutive DP rows a thread
constexpr int MAX_THREADS = 256;    // threads a window, at most
constexpr int COUNT_WARPS = 8;      // windows a block of the count kernel
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_STAGE = 16384;    // stage bytes a row (q and t: twice that)
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// Exclusive scan of v over the block's threads (blockDim.x a multiple of
// 32); `total` gets the block's sum.  Every thread calls it; it ends with
// a barrier, so `tmp` (32 entries) may be used again at once.
template <typename T>
__device__ T block_exclusive_scan(T v, T* tmp, T& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) tmp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = lane < nw ? tmp[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        if (lane < nw) tmp[lane] = s;
    }
    __syncthreads();
    const T before = warp ? tmp[warp - 1] : T(0);
    total = tmp[nw - 1];
    __syncthreads();
    return before + x - v;
}

// cols[w] = j_rem + m + sum(cnt[:m]), or -1 where the records do not fit
__global__ void __launch_bounds__(COUNT_WARPS * 32)
emit_count_kernel(const uint8_t* __restrict__ cnts,
                  const int8_t* __restrict__ mv0s,
                  const int32_t* __restrict__ j_rem,
                  const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                  long long* __restrict__ cols, int B, int mrows) {
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * COUNT_WARPS + (threadIdx.x >> 5);
    if (w >= B) return;  // whole warps only
    const int mb = m[w], nb = n[w], jr = j_rem[w];
    const bool bad = mb < 0 || mb > mrows || nb < 0 || jr < 0;
    long long left = 0, ups = 0;
    if (!bad) {
        const long long row0 = static_cast<long long>(w) * mrows;
        for (int r = lane; r < mb; r += 32) {
            left += cnts[row0 + r];
            ups += mv0s[row0 + r] == 1;
        }
    }
    left = warp_sum(left);
    ups = warp_sum(ups);
    if (lane == 0) {
        const long long c = static_cast<long long>(jr) + mb + left;
        cols[w] = (bad || c - ups != nb) ? -1 : c;
    }
}

// qoff / toff: where each window's bases start in q / t; meta[w]: its
// base in the rows, meta[B] the total, meta[B + 1] the windows that do
// not fit (their cols set to -1)
__global__ void __launch_bounds__(SCAN_THREADS)
emit_scan_kernel(const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                 long long* __restrict__ cols, long long* __restrict__ qoff,
                 long long* __restrict__ toff, long long* __restrict__ meta,
                 int B, long long q_len, long long t_len) {
    __shared__ long long tmp[32];
    long long cq = 0, ct = 0, cc = 0, nbad = 0, tot;
    for (int w0 = 0; w0 < B; w0 += blockDim.x) {
        const int w = w0 + threadIdx.x;
        const bool in = w < B;
        const long long mq = in ? max(m[w], 0) : 0;
        const long long nt = in ? max(n[w], 0) : 0;
        long long c = in ? cols[w] : 0;
        const long long qo = cq + block_exclusive_scan(mq, tmp, tot);
        cq += tot;
        const long long to = ct + block_exclusive_scan(nt, tmp, tot);
        ct += tot;
        const bool bad = in && (c < 0 || qo + mq > q_len || to + nt > t_len);
        if (bad) c = 0;
        const long long base = cc + block_exclusive_scan(c, tmp, tot);
        cc += tot;
        block_exclusive_scan(static_cast<long long>(bad), tmp, tot);
        nbad += tot;
        if (in) {
            qoff[w] = qo;
            toff[w] = to;
            meta[w] = base;
            if (bad) cols[w] = -1;
        }
    }
    if (threadIdx.x == 0) {
        meta[B] = cc;
        meta[B + 1] = nbad;
    }
}

// len bytes from shared src to global dst, equal mod 16: 16-byte stores
// between the ragged ends
__device__ __forceinline__ void copy_out(uint8_t* dst, const uint8_t* src,
                                         int len) {
    const int tid = threadIdx.x, nt = blockDim.x;
    int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
    head = head < len ? head : len;
    const int words = (len - head) >> 4;
    if (tid < head) dst[tid] = src[tid];
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    for (int i = tid; i < words; i += nt) d4[i] = s4[i];
    for (int i = head + (words << 4) + tid; i < len; i += nt) dst[i] = src[i];
}

__global__ void __launch_bounds__(MAX_THREADS)
emit_rows_kernel(const uint8_t* __restrict__ cnts,
                 const int8_t* __restrict__ mv0s,
                 const int32_t* __restrict__ j_rem,
                 const int32_t* __restrict__ m,
                 const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const long long* __restrict__ cols,
                 const long long* __restrict__ qoff,
                 const long long* __restrict__ toff,
                 const long long* __restrict__ meta,
                 uint8_t* __restrict__ rows, int B, int mrows, int stage) {
    extern __shared__ __align__(16) uint8_t smem[];  // q stage, then t stage
    __shared__ u64 tmp[32];
    const int w = blockIdx.x;
    if (cols[w] < 0) return;  // no columns: the whole block leaves
    const long long total = meta[B], base = meta[w];
    uint8_t* gq = rows + base;
    uint8_t* gt = rows + total + base;
    const uint8_t* qb = q + qoff[w];
    const uint8_t* tb = t + toff[w];
    const int mb = m[w], jr = j_rem[w];
    const int tid = threadIdx.x, nt = blockDim.x;

    // the j_rem leading left columns: t's first bases against gaps
    for (int c = tid; c < jr; c += nt) {
        gq[c] = GAP;
        gt[c] = tb[c];
    }
    const long long row0 = static_cast<long long>(w) * mrows;
    long long col0 = jr;  // the chunk's first column
    long long ups0 = 0;   // up columns before it
    for (int r0 = 0; r0 < mb; r0 += nt * ITEMS) {
        const int rb = r0 + tid * ITEMS;
        int cnt[ITEMS];
        bool up[ITEMS];
        uint8_t qv[ITEMS];
        unsigned seg = 0, nup = 0;
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const bool live = rb + i < mb;
            cnt[i] = live ? cnts[row0 + rb + i] : -1;
            up[i] = live && mv0s[row0 + rb + i] == 1;
            qv[i] = live ? qb[rb + i] : 0;
            seg += live ? cnt[i] + 1 : 0;
            nup += up[i] ? 1 : 0;
        }
        u64 tot;
        const u64 ex = block_exclusive_scan<u64>(seg | (static_cast<u64>(nup) << 32),
                                                 tmp, tot);
        const int span = static_cast<int>(tot & FULL);  // the chunk's columns
        long long c = col0 + static_cast<long long>(ex & FULL);
        long long u = ups0 + static_cast<long long>(ex >> 32);
        // stage index of column col0 + k: shift + k, shift the destination's
        // address mod 16
        const int sq = static_cast<int>(reinterpret_cast<uintptr_t>(gq + col0) & 15);
        const int st = static_cast<int>(reinterpret_cast<uintptr_t>(gt + col0) & 15);
        const bool staged = span + 16 <= stage;  // uniform over the block
        uint8_t* const qs = smem + sq;
        uint8_t* const ts = smem + stage + st;
        auto put = [&](long long col, uint8_t qc, uint8_t tc) {
            if (staged) {
                qs[col - col0] = qc;
                ts[col - col0] = tc;
            } else {
                gq[col] = qc;
                gt[col] = tc;
            }
        };
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            if (cnt[i] < 0) break;  // live rows are a prefix of the thread's
            const long long tx = c - u;  // t index at c were it not an up column
            const int upi = up[i] ? 1 : 0;
            put(c, qv[i], upi ? GAP : tb[tx]);
            for (int k = 1; k <= cnt[i]; ++k) put(c + k, GAP, tb[tx + k - upi]);
            c += cnt[i] + 1;
            u += upi;
        }
        if (staged) {
            __syncthreads();
            copy_out(gq + col0, qs, span);
            copy_out(gt + col0, ts, span);
        }
        col0 += span;
        ups0 += static_cast<long long>(tot >> 32);
        __syncthreads();  // the stage is free again
    }
}

}  // namespace

extern "C" int hinge_emit_rows(const void* cnts, const void* mv0s,
                               const void* j_rem, const void* m, const void* n,
                               const void* q, long long q_len, const void* t,
                               long long t_len, void* scratch, void* meta,
                               void* rows, int B, int mrows, int threads,
                               int stage, void* stream) {
    if (B <= 0) return 0;
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
        stage < 32 || stage > MAX_STAGE || stage % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    auto* cols = static_cast<long long*>(scratch);
    long long* qoff = cols + B;
    long long* toff = qoff + B;
    const auto* cp = static_cast<const uint8_t*>(cnts);
    const auto* vp = static_cast<const int8_t*>(mv0s);
    const auto* jp = static_cast<const int32_t*>(j_rem);
    const auto* mp = static_cast<const int32_t*>(m);
    const auto* np_ = static_cast<const int32_t*>(n);
    auto* mt = static_cast<long long*>(meta);
    emit_count_kernel<<<(B + COUNT_WARPS - 1) / COUNT_WARPS, COUNT_WARPS * 32, 0, s>>>(
        cp, vp, jp, mp, np_, cols, B, mrows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    emit_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(mp, np_, cols, qoff, toff, mt,
                                                B, q_len, t_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    emit_rows_kernel<<<B, threads, 2 * stage, s>>>(
        cp, vp, jp, mp, static_cast<const uint8_t*>(q),
        static_cast<const uint8_t*>(t), cols, qoff, toff, mt,
        static_cast<uint8_t*>(rows), B, mrows, stage);
    return static_cast<int>(cudaGetLastError());
}
