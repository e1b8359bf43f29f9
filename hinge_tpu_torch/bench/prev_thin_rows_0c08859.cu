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
// What bounds it on this card: bytes.  Each anchor's (row, q, t) is read
// once and each kept anchor's (q, t, row) written once, 24 bytes each,
// plus 57 bytes of row spans; the operations (a subtract and a compare a
// walked anchor) are far below that.
// What the design does about it: the walk is sequential within a row and
// independent across rows, so one thread walks one row once, O(n_a) work
// in all where pointer doubling did O(n_a log L) scattered passes.
//   1. bounds: one thread an anchor marks where each row starts and ends;
//   2. walk:   one thread a row writes its kept anchors compacted at the
//              start of its own input segment (scratch k_q, k_t), its
//              kept count m and its spans (Q0, Q1, T0, T1, okr, nb);
//   3. the caller takes fr_start = exclusive prefix sum of m and n_f;
//   4. gather: one thread an anchor moves the kept ones to f at
//              fr_start[row] + their place in the row, coalesced.
// A warp's threads walk rows of different lengths, so a warp waits for
// its longest row, and a thread's loads are strided across the warp:
// that is the next redesign's to fix (a warp a row with ballots).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int THREADS = 128;

__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
    const i64 q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(THREADS)
row_bounds_kernel(const i64* __restrict__ a_row, i64 n_a, i64 n_rows,
                  i64* __restrict__ r_start, i64* __restrict__ r_end) {
    for (i64 i = blockIdx.x * static_cast<i64>(blockDim.x) + threadIdx.x;
         i < n_a; i += static_cast<i64>(gridDim.x) * blockDim.x) {
        const i64 r = a_row[i];
        if (r < 0 || r >= n_rows) continue;
        if (i == 0 || a_row[i - 1] != r) r_start[r] = i;
        if (i == n_a - 1 || a_row[i + 1] != r) r_end[r] = i + 1;
    }
}

__global__ void __launch_bounds__(THREADS)
walk_kernel(const i64* __restrict__ a_q, const i64* __restrict__ a_t,
            const i64* __restrict__ r_start, const i64* __restrict__ r_end,
            i64 n_rows, i64 k, i64 sub_gap, i64 min_span, i64 min_cnt,
            i64 tspace, i64* __restrict__ k_q, i64* __restrict__ k_t,
            i64* __restrict__ m_out, i64* __restrict__ Q0,
            i64* __restrict__ Q1, i64* __restrict__ T0, i64* __restrict__ T1,
            bool* __restrict__ okr, i64* __restrict__ nb) {
    for (i64 r = blockIdx.x * static_cast<i64>(blockDim.x) + threadIdx.x;
         r < n_rows; r += static_cast<i64>(gridDim.x) * blockDim.x) {
        const i64 s = r_start[r], e = r_end[r];
        i64 m = 0, q0 = 0, t0 = 0, q1 = 0, t1 = 0;
        if (s < e) {
            i64 last_q = a_q[s], max_t = a_t[s];
            k_q[s] = last_q;
            k_t[s] = max_t;
            m = 1;
            q0 = q1 = last_q;
            t0 = t1 = max_t;
            for (i64 i = s + 1; i < e; ++i) {
                const i64 q = a_q[i];
                // the greedy step, then the last-anchor rule (both
                // before the t filter)
                if (q - last_q < sub_gap && (i != e - 1 || q == last_q))
                    continue;
                last_q = q;
                const i64 t = a_t[i];
                if (t < max_t) continue;  // the monotone-t filter
                max_t = t;
                k_q[s + m] = q;
                k_t[s + m] = t;
                ++m;
                q1 = q;
                t1 = t;
            }
            q1 += k;
            t1 += k;
        }
        const bool ok =
            m >= min_cnt && q1 - q0 >= min_span && t1 - t0 >= min_span;
        const i64 n_int = floordiv(t1 - 1, tspace) - floordiv(t0, tspace);
        m_out[r] = m;
        Q0[r] = q0;
        Q1[r] = q1;
        T0[r] = t0;
        T1[r] = t1;
        okr[r] = ok;
        nb[r] = ok ? (n_int > 0 ? n_int : 0) + 2 : 0;
    }
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const i64* __restrict__ a_row, i64 n_a, i64 n_rows,
              const i64* __restrict__ r_start, const i64* __restrict__ m,
              const i64* __restrict__ fr_start, const i64* __restrict__ k_q,
              const i64* __restrict__ k_t, i64* __restrict__ f_q,
              i64* __restrict__ f_t, i64* __restrict__ f_row) {
    for (i64 i = blockIdx.x * static_cast<i64>(blockDim.x) + threadIdx.x;
         i < n_a; i += static_cast<i64>(gridDim.x) * blockDim.x) {
        const i64 r = a_row[i];
        if (r < 0 || r >= n_rows) continue;
        const i64 j = i - r_start[r];
        if (j < 0 || j >= m[r]) continue;
        const i64 o = fr_start[r] + j;
        f_q[o] = k_q[i];
        f_t[o] = k_t[i];
        f_row[o] = r;
    }
}

unsigned grid_for(i64 n) {
    const i64 g = (n + THREADS - 1) / THREADS;
    return static_cast<unsigned>(g < (1 << 20) ? g : (1 << 20));
}

}  // namespace

// Steps 1-2 on `stream`.  a_row, a_q, a_t int64 [n_a], sorted by
// (row, q, t), rows 0..n_rows-1; every output int64 [n_rows] but okr
// (bool) and the scratch k_q, k_t int64 [n_a].  A row with no anchor
// gets m = 0.  Returns the launch's cudaError.
extern "C" int hinge_thin_rows(const void* a_row, const void* a_q,
                               const void* a_t, i64 n_a, i64 n_rows, i64 k,
                               i64 sub_gap, i64 min_span, i64 min_cnt,
                               i64 tspace, void* r_start, void* r_end,
                               void* k_q, void* k_t, void* m, void* Q0,
                               void* Q1, void* T0, void* T1, void* okr,
                               void* nb, void* stream) {
    if (n_rows <= 0) return 0;
    const auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(r_start, 0, n_rows * sizeof(i64), st);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(r_end, 0, n_rows * sizeof(i64), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_a > 0)
        row_bounds_kernel<<<grid_for(n_a), THREADS, 0, st>>>(
            static_cast<const i64*>(a_row), n_a, n_rows,
            static_cast<i64*>(r_start), static_cast<i64*>(r_end));
    walk_kernel<<<grid_for(n_rows), THREADS, 0, st>>>(
        static_cast<const i64*>(a_q), static_cast<const i64*>(a_t),
        static_cast<const i64*>(r_start), static_cast<const i64*>(r_end),
        n_rows, k, sub_gap, min_span, min_cnt, tspace,
        static_cast<i64*>(k_q), static_cast<i64*>(k_t), static_cast<i64*>(m),
        static_cast<i64*>(Q0), static_cast<i64*>(Q1), static_cast<i64*>(T0),
        static_cast<i64*>(T1), static_cast<bool*>(okr),
        static_cast<i64*>(nb));
    return static_cast<int>(cudaGetLastError());
}

// Step 4 on `stream`: f_q, f_t, f_row int64 [sum of m], from step 2's
// scratch and the prefix sum fr_start of m.
extern "C" int hinge_thin_rows_gather(const void* a_row, i64 n_a, i64 n_rows,
                                      const void* r_start, const void* m,
                                      const void* fr_start, const void* k_q,
                                      const void* k_t, void* f_q, void* f_t,
                                      void* f_row, void* stream) {
    if (n_a <= 0 || n_rows <= 0) return 0;
    gather_kernel<<<grid_for(n_a), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const i64*>(a_row), n_a, n_rows,
        static_cast<const i64*>(r_start), static_cast<const i64*>(m),
        static_cast<const i64*>(fr_start), static_cast<const i64*>(k_q),
        static_cast<const i64*>(k_t), static_cast<i64*>(f_q),
        static_cast<i64*>(f_t), static_cast<i64*>(f_row));
    return static_cast<int>(cudaGetLastError());
}
