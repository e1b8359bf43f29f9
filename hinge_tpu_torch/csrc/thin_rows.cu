// The device join's p3: greedy sub_gap thinning, the last-anchor rule,
// the monotone-t filter and the per-row spans, for Hopper.
//
// Replaces the jitted XLA program hinge_tpu/overlap/device_join.py::
// _join_fns.p3 (:475), which marks each row's emission set by pointer
// doubling over every anchor of the block; the plain torch twin is
// hinge_tpu_torch/overlap/device_join.py::thin_rows_ref.  Outputs are
// bit-identical to it.
//
// Per row of anchors sorted by (row, q, t), in index order: emit the
// head; emit each anchor whose q is >= the last emitted q + sub_gap;
// emit the row's last anchor if its q differs from the last emitted q
// (native/io_native.cpp's emit loop); keep an emitted anchor when its t
// is >= the largest t emitted before it in the row.
//
// What bounds it on this card: bytes, in the limit.  Each anchor's q and
// t are read once (16 bytes), each kept anchor's (q, t, row) written once
// (24), a row's spans written once (57) and the sector of a_row that holds
// its first anchor read; the operations (a compare a walked anchor, a few
// an emitted one) are far below that.  But the greedy step is a chain
// through a row, and a join block's rows hold from 1 to a few thousand
// anchors (~330 on average, 2,359 at most on the 4.6 Mb join's largest
// block): a thread walking a row takes as long as its longest row (the
// previous design, one thread a row), so the rows are walked by warps,
// and then the walk is bound by the instructions a warp issues a chunk.
// What the design does about it:
//   1. bounds: a thread a row boundary binary-searches a_row (sorted) for
//      the row's first anchor, so a_row is read only at the probes (the
//      upper ones shared by all rows, in L2), not in full;
//   2. walk: a warp a row, rows handed out in order by a ticket counter
//      (the next ticket and its bounds fetched during the current row),
//      so that a warp ending a short row takes the next one at once.  The
//      warp reads its row in chunks of 32 anchors, one 256-byte coalesced
//      load each of a_q and a_t (evict-first: read once), DEPTH chunks in
//      flight.  The greedy step: the threshold (last emitted q +
//      sub_gap) is carried across chunks; q is sorted, so the lanes at
//      or past it are a suffix, and the first lane (__ffs) of their
//      __ballot_sync is the next emitted anchor, once per emission (~9 a
//      chunk on the join's blocks), its q and t shuffled to every lane;
//      the monotone-t filter tests each emission against the carried
//      max_t; on the row's last chunk the last-anchor rule.  In 64 bits,
//      so exact on every input: a 32-bit form (successors by a shuffle
//      search, the entry's orbit) walked the join's largest block only
//      5% faster (PERF.md).  Kept lanes take their slot by __popc of the
//      kept mask below them and write coalesced to the scratch at the
//      row's input offset; lane 0 writes the row's count and spans, and
//      each block takes its rows' smallest count into stats (one atomic);
//   3. the caller takes fr_end = cumsum of the counts, and its one host
//      sync reads fr_end's last word (n_f) and the smallest count;
//   4. copy: a warp a row copies its kept anchors from the scratch to f
//      at fr_start = fr_end - m, coalesced, UNROLL groups of 32 in flight
//      (faster than a second walk writing f, which reads a_q and a_t
//      twice; PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int WARPS = 4;  // a block's warps, each walking a row at a time
constexpr int THREADS = 32 * WARPS;
constexpr int DEPTH = 4;  // chunks of its row a warp has in flight
constexpr int UNROLL = 4;  // 32-anchor groups a copying warp has in flight
constexpr unsigned FULL = 0xffffffffu;

// the words of `stats`: the smallest count and the walk's ticket counter
enum Stat : int { M_MIN = 0, TICKET = 1 };

__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
    const i64 q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// r_start[r] = the first index i with a_row[i] >= r, r = 0..n_rows; also
// resets the ticket counter and the smallest count
__global__ void __launch_bounds__(THREADS)
bounds_kernel(const i64* __restrict__ a_row, i64 n_a, i64 n_rows,
              i64* __restrict__ r_start, i64* __restrict__ stats) {
    const i64 first = blockIdx.x * static_cast<i64>(blockDim.x) + threadIdx.x;
    if (first == 0) {
        stats[M_MIN] = LLONG_MAX;
        stats[TICKET] = 0;
    }
    for (i64 r = first; r <= n_rows;
         r += static_cast<i64>(gridDim.x) * blockDim.x) {
        i64 lo = 0, hi = n_a;
        while (lo < hi) {
            const i64 mid = lo + ((hi - lo) >> 1);
            if (a_row[mid] < r)
                lo = mid + 1;
            else
                hi = mid;
        }
        r_start[r] = lo;
    }
}

// the walk's arguments (see hinge_thin_rows_walk)
struct WalkArgs {
    const i64 *a_q, *a_t, *r_start;
    i64 n_rows, k, sub_gap, min_span, min_cnt, tspace;
    i64 *k_q, *k_t, *m, *Q0, *Q1, *T0, *T1;
    bool* okr;
    i64 *nb, *stats;
};

// a row's walk state carried from chunk to chunk: whether it has emitted
// an anchor yet, the last emitted q, the largest emitted t, and the last
// kept anchor
struct Carry {
    bool any;
    i64 last_q, max_t, q1, t1;
};

// One chunk of a row: lane i holds the anchor base + i, `left` anchors of
// the row from base on.  Runs the greedy step once per emitted anchor (q
// is sorted, so the lanes at or past the threshold are a suffix: the
// first lane of their ballot is the next emission) with the t filter on
// each, and on the row's last chunk the last-anchor rule; returns the
// kept lanes.
__device__ __forceinline__ unsigned resolve(i64 q, i64 t, i64 left,
                                                 i64 sub_gap, Carry& c) {
    i64 thr = c.any ? c.last_q + sub_gap : LLONG_MIN;
    unsigned live = left >= 32 ? FULL : (1u << left) - 1u;
    unsigned keep = 0;
    for (;;) {
        const unsigned b = __ballot_sync(FULL, q >= thr) & live;
        if (b == 0) break;
        const int f = __ffs(b) - 1;
        const i64 qf = __shfl_sync(FULL, q, f);
        const i64 tf = __shfl_sync(FULL, t, f);
        c.any = true;
        c.last_q = qf;
        thr = qf + sub_gap;
        live &= ~((2u << f) - 1u);  // the lanes after f
        if (tf >= c.max_t) {        // the monotone-t filter
            keep |= 1u << f;
            c.max_t = tf;
            c.q1 = qf;
            c.t1 = tf;
        }
    }
    if (left <= 32) {  // the last-anchor rule, on the row's last chunk
        const int l = static_cast<int>(left) - 1;
        const i64 ql = __shfl_sync(FULL, q, l);
        const i64 tl = __shfl_sync(FULL, t, l);
        if (ql != c.last_q && tl >= c.max_t) {
            keep |= 1u << l;
            c.q1 = ql;
            c.t1 = tl;
        }
    }
    return keep;
}

__global__ void __launch_bounds__(THREADS)
walk_kernel(const WalkArgs a) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    // rows are handed out in order, one ticket a row, so a warp that ends
    // a short row takes the next one; the next ticket and its bounds are
    // fetched while the warp walks its row
    auto* tickets = reinterpret_cast<unsigned long long*>(a.stats + TICKET);
    auto ticket = [&]() {
        i64 r = 0;
        if (lane == 0) r = static_cast<i64>(atomicAdd(tickets, 1ull));
        return __shfl_sync(FULL, r, 0);
    };
    i64 m_min = LLONG_MAX;  // the smallest count of the warp's rows
    i64 r = ticket(), s = 0, e = 0;
    if (r < a.n_rows) {
        s = a.r_start[r];
        e = a.r_start[r + 1];
    }
    while (r < a.n_rows) {
        const i64 r_next = ticket();
        // a ring of DEPTH chunks in flight: slot j holds chunk j mod DEPTH
        i64 rq[DEPTH], rt[DEPTH];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            const i64 i = s + 32 * j + lane;
            rq[j] = i < e ? __ldcs(a.a_q + i) : 0;
            rt[j] = i < e ? __ldcs(a.a_t + i) : 0;
        }
        i64 s_next = 0, e_next = 0;
        if (r_next < a.n_rows) {
            s_next = a.r_start[r_next];
            e_next = a.r_start[r_next + 1];
        }
        // the head (lane 0 of the first chunk) is emitted and kept
        const i64 q0 = __shfl_sync(FULL, rq[0], 0);
        const i64 t0 = __shfl_sync(FULL, rt[0], 0);
        Carry c{false, 0, LLONG_MIN, 0, 0};
        i64 m = 0;
        for (i64 base = s; base < e; base += 32 * DEPTH) {
#pragma unroll
            for (int j = 0; j < DEPTH; ++j) {
                const i64 cb = base + 32 * j;
                if (cb >= e) break;
                const i64 q = rq[j], t = rt[j];
                const i64 i = cb + 32 * DEPTH + lane;
                rq[j] = i < e ? __ldcs(a.a_q + i) : 0;  // the chunk DEPTH on
                rt[j] = i < e ? __ldcs(a.a_t + i) : 0;
                const unsigned keep = resolve(q, t, e - cb, a.sub_gap, c);
                if (keep >> lane & 1u) {
                    const i64 o = s + m + __popc(keep & below);
                    a.k_q[o] = q;
                    a.k_t[o] = t;
                }
                m += __popc(keep);
            }
        }
        if (lane == 0) {
            const i64 q1 = m > 0 ? c.q1 + a.k : 0;
            const i64 t1 = m > 0 ? c.t1 + a.k : 0;
            const bool ok = m >= a.min_cnt && q1 - q0 >= a.min_span &&
                            t1 - t0 >= a.min_span;
            const i64 n_int =
                floordiv(t1 - 1, a.tspace) - floordiv(t0, a.tspace);
            a.m[r] = m;
            a.Q0[r] = q0;
            a.Q1[r] = q1;
            a.T0[r] = t0;
            a.T1[r] = t1;
            a.okr[r] = ok;
            a.nb[r] = ok ? (n_int > 0 ? n_int : 0) + 2 : 0;
        }
        m_min = m < m_min ? m : m_min;
        r = r_next;
        s = s_next;
        e = e_next;
    }
    __shared__ i64 mins[WARPS];
    if (lane == 0) mins[threadIdx.x >> 5] = m_min;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m_min = mins[w] < m_min ? mins[w] : m_min;
        if (m_min != LLONG_MAX) atomicMin(a.stats + M_MIN, m_min);
    }
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const i64* __restrict__ r_start, const i64* __restrict__ m,
            const i64* __restrict__ fr_end, const i64* __restrict__ k_q,
            const i64* __restrict__ k_t, i64 n_rows, i64* __restrict__ f_q,
            i64* __restrict__ f_t, i64* __restrict__ f_row,
            i64* __restrict__ fr_start) {
    const int lane = threadIdx.x & 31;
    for (i64 r = blockIdx.x * static_cast<i64>(WARPS) + (threadIdx.x >> 5);
         r < n_rows; r += static_cast<i64>(gridDim.x) * WARPS) {
        const i64 s = r_start[r], n = m[r], o = fr_end[r] - n;
        if (lane == 0) fr_start[r] = o;
        for (i64 j0 = lane; j0 < n; j0 += 32 * UNROLL) {
            i64 vq[UNROLL], vt[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const i64 j = j0 + 32 * u;
                vq[u] = j < n ? __ldcs(k_q + s + j) : 0;
                vt[u] = j < n ? __ldcs(k_t + s + j) : 0;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const i64 j = j0 + 32 * u;
                if (j < n) {
                    f_q[o + j] = vq[u];
                    f_t[o + j] = vt[u];
                    f_row[o + j] = r;
                }
            }
        }
    }
}

unsigned grid_for(i64 n, i64 per_block) {
    const i64 g = (n + per_block - 1) / per_block;
    return static_cast<unsigned>(g < (1 << 20) ? g : (1 << 20));
}

// the walk's grid: a block for each WARPS rows, at most as many blocks as
// the card holds at once (their warps then take rows by ticket)
unsigned walk_grid(i64 n_rows) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const unsigned most =
        static_cast<unsigned>(sms > 0 ? sms : 1) * (2048 / THREADS);
    const unsigned g = grid_for(n_rows, WARPS);
    return g < most ? g : most;
}

}  // namespace

// Step 1 on `stream`: r_start int64 [n_rows + 1] from a_row int64 [n_a]
// (sorted; rows 0..n_rows-1), and stats int64 [2] reset.  Returns the
// launch's cudaError.
extern "C" int hinge_thin_rows_bounds(const void* a_row, i64 n_a, i64 n_rows,
                                      void* r_start, void* stats,
                                      void* stream) {
    if (n_rows <= 0) return 0;
    bounds_kernel<<<grid_for(n_rows + 1, THREADS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(a_row), n_a, n_rows,
        static_cast<i64*>(r_start), static_cast<i64*>(stats));
    return static_cast<int>(cudaGetLastError());
}

// Step 2 on `stream`, a warp a row of a_q, a_t int64 [n_a] (sorted by
// (row, q, t)) between r_start[r] and r_start[r + 1]: leaves the kept
// anchors in k_q, k_t int64 [n_a] at their row's input offset, writes m,
// Q0, Q1, T0, T1, nb int64 and okr bool [n_rows] and takes the smallest m
// into stats[0].  A row with no anchor gets m = 0.  Returns the launch's
// cudaError.
extern "C" int hinge_thin_rows_walk(const void* a_q, const void* a_t,
                                    const void* r_start, i64 n_rows, i64 k,
                                    i64 sub_gap, i64 min_span, i64 min_cnt,
                                    i64 tspace, void* k_q, void* k_t, void* m,
                                    void* Q0, void* Q1, void* T0, void* T1,
                                    void* okr, void* nb, void* stats,
                                    void* stream) {
    if (n_rows <= 0) return 0;
    const WalkArgs args{
        static_cast<const i64*>(a_q), static_cast<const i64*>(a_t),
        static_cast<const i64*>(r_start), n_rows, k, sub_gap, min_span,
        min_cnt, tspace, static_cast<i64*>(k_q), static_cast<i64*>(k_t),
        static_cast<i64*>(m), static_cast<i64*>(Q0), static_cast<i64*>(Q1),
        static_cast<i64*>(T0), static_cast<i64*>(T1), static_cast<bool*>(okr),
        static_cast<i64*>(nb), static_cast<i64*>(stats)};
    walk_kernel<<<walk_grid(n_rows), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(args);
    return static_cast<int>(cudaGetLastError());
}

// Step 3's sync on `stream`: host int64 [2] = (fr_end[n_rows - 1], the
// smallest count stats[0]), read once the stream is done.  Returns the
// cudaError.
extern "C" int hinge_thin_rows_sync(const void* fr_end, i64 n_rows,
                                    const void* stats, void* host,
                                    void* stream) {
    const auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemcpyAsync(
        host, static_cast<const i64*>(fr_end) + (n_rows - 1), sizeof(i64),
        cudaMemcpyDeviceToHost, st);
    if (err == cudaSuccess)
        err = cudaMemcpyAsync(static_cast<i64*>(host) + 1,
                              static_cast<const i64*>(stats) + M_MIN,
                              sizeof(i64), cudaMemcpyDeviceToHost, st);
    if (err == cudaSuccess) err = cudaStreamSynchronize(st);
    return static_cast<int>(err);
}

// Step 4 on `stream`: f_q, f_t, f_row int64 [n_f] and fr_start [n_rows]
// from the walk's k_q, k_t, r_start, m and fr_end = cumsum(m).
// Returns the launch's cudaError.
extern "C" int hinge_thin_rows_copy(const void* r_start, const void* m,
                                    const void* fr_end, const void* k_q,
                                    const void* k_t, i64 n_rows, void* f_q,
                                    void* f_t, void* f_row, void* fr_start,
                                    void* stream) {
    if (n_rows <= 0) return 0;
    copy_kernel<<<grid_for(n_rows, WARPS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(r_start), static_cast<const i64*>(m),
        static_cast<const i64*>(fr_end), static_cast<const i64*>(k_q),
        static_cast<const i64*>(k_t), n_rows, static_cast<i64*>(f_q),
        static_cast<i64*>(f_t), static_cast<i64*>(f_row),
        static_cast<i64*>(fr_start));
    return static_cast<int>(cudaGetLastError());
}
