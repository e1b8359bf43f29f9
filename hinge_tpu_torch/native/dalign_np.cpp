// Copied from hinge_tpu/native/dalign_np.cpp, unchanged.
//
// Exact DALIGNER trace-window alignment, batched.
//
// Re-implements (behavior-for-behavior, tie-break-for-tie-break) the private
// iter_np() of the reference's LAInterface.cpp:3152-3407 — the O(nd)
// wavefront alignment with "uppermost" path normalization that
// computeTracePTS (LAInterface.cpp:3410) runs inside every trace-point
// window — and the row emission of getAlignmentTags (LAInterface.cpp:3709-
// 3915).  Draft/consensus byte-parity with the reference binaries depends on
// reproducing this exact alignment path, not merely an optimal one: the
// wave's move preference and the uppermost traceback re-threading pick one
// specific path among all optimal paths.
//
// Context matters: the wave's diagonal slides can compare bytes one position
// BEFORE a window (frontier diagonals enter the slide at j = -1, reading
// B[-1] and A[k-1]) and the traceback can read one byte past the window end
// (c starts at N).  The reference's buffers are Load_Subread(abpos-10 ..
// aepos+10) with a 4-sentinel on each side (DB.c:1449-1459), so those reads
// hit real neighboring bases / sentinels.  Callers therefore pass whole
// padded CONTEXT buffers per alignment plus per-window offsets; `avail` is
// how many valid bytes exist before each window start (reads further below
// — which in the reference hit unreproducible malloc garbage — are treated
// as mismatches).
//
// Coordinates: one window aligns A[0..M) to B[0..N) where A/B are pointers
// into the padded contexts.  Emitted script entries are window-local,
// 1-based: +p = insertion in B at B position p, -p = deletion at A position
// p (the reference's global trace values minus the window offsets ap/bp,
// LAInterface.cpp:3288-3290).
//
// Row emission (getAlignmentTags' loop, LAInterface.cpp:3829-3871) writes
// base codes 0..3 and GAP=4 (the reference uses 7 -> '-'; we keep our
// pipeline-wide gap code).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kGap = 4;
constexpr int kOutOfBuffer = 0x7f;  // never equal to any base/sentinel code

// Wave arena for one window: rows d = -2 .. D, diagonals k = -(N+1)..(M+1).
struct WaveArena {
    std::vector<int32_t> pvf, phf;
    int span = 0, koff = 0, rows = 0;

    void reset(int M, int N) {
        span = M + N + 6;
        koff = N + 2;
        rows = M + N + 4;
        size_t need = static_cast<size_t>(rows) * span;
        if (pvf.size() < need) {
            pvf.resize(need);
            phf.resize(need);
        }
    }
    int32_t *V(int d) { return pvf.data() + static_cast<size_t>(d + 2) * span + koff; }
    int32_t *H(int d) { return phf.data() + static_cast<size_t>(d + 2) * span + koff; }
};

// One window: exact iter_np.  `a_avail` = valid bytes before A (reads at
// A[x] with x < -a_avail are mismatches).  Appends window-local signed
// script entries to `script`.
static void iter_np_window(const uint8_t *A, int M, int a_avail,
                           const uint8_t *B, int N,
                           WaveArena &w, std::vector<int32_t> &script) {
    w.reset(M, N);
    const int del = M - N;
    int D;

    // guarded A read for the diagonal slides (index can dip below -1)
    auto Aat = [&](int x) -> int {
        return (x >= -a_avail) ? A[x] : kOutOfBuffer;
    };

    // FS_MOVE (LAInterface.cpp:3225-3250): pick among am / ac=F1[k]+1 / ap
    // with the reference's exact comparison chain, then slide the diagonal.
    // `aoff` is the diagonal's A offset (a = A + k in the reference).
    auto fs_move = [&](int32_t *F0, int32_t *HF, const int32_t *F1,
                       int k, int i, int aoff, int am, int ap,
                       int mdir, int pdir) {
        int ac = F1[k] + 1;
        int j;
        if (ac < am) {
            if (ap < am) { HF[k] = mdir; j = am; }
            else         { HF[k] = pdir; j = ap; }
        } else {
            if (ap < ac) { HF[k] = 0;    j = ac; }
            else         { HF[k] = pdir; j = ap; }
        }
        if (N < i) { while (j < N && B[j] == Aat(aoff + j)) j += 1; }
        else       { while (j < i && B[j] == Aat(aoff + j)) j += 1; }
        F0[k] = j;
        return j;
    };

    {
        int low, hgh;
        if (del >= 0) { low = 0; hgh = del; }
        else          { low = del; hgh = 0; }

        int32_t *F1 = w.V(-2);
        int32_t *F0 = w.V(-1);
        for (int d = low - 1; d <= hgh + 1; d++) F1[d] = F0[d] = -2;
        F0[0] = -1;

        low += 1;
        hgh -= 1;

        for (D = 0;; D += 1) {
            int32_t *F2 = F1;
            F1 = F0;
            F0 = w.V(D);
            int32_t *HF = w.H(D);

            if ((D & 0x1) == 0) { low -= 1; hgh += 1; }
            F0[hgh + 1] = F0[low - 1] = -2;

            int j, i, k, aoff;

            j = -2;
            aoff = hgh;
            i = M - hgh;
            for (k = hgh; k > del; k--) {
                int ap = j + 1;
                int am = F2[k - 1];
                j = fs_move(F0, HF, F1, k, i, aoff, am, ap, -1, 4);
                aoff -= 1;
                i += 1;
            }

            j = -2;
            aoff = low;
            i = M - low;
            for (k = low; k < del; k++) {
                int ap = F2[k + 1] + 1;
                int am = j;
                j = fs_move(F0, HF, F1, k, i, aoff, am, ap, 2, 1);
                aoff += 1;
                i -= 1;
            }

            {
                int ap = F0[del + 1] + 1;
                int am = j;
                fs_move(F0, HF, F1, del, i, aoff, am, ap, 2, 4);
            }

            if (F0[del] >= N) break;
        }
    }

    // Uppermost traceback re-threading + script emission
    // (LAInterface.cpp:3286-3377).  Window-local: ap = -1, bp = +1.
    {
        const int apc = -1, bpc = 1;
        int k, h, m, e, c;

        w.H(0)[0] = 3;

        c = N;
        k = del;
        int Dd = D;
        e = w.H(Dd)[k];
        w.H(Dd)[k] = 3;
        while (e != 3) {
            h = k + e;
            if (e > 1) h -= 3;
            else if (e == 0) Dd -= 1;
            else Dd -= 2;
            if (h < k) {  // e = -1 or 2: normalize upward
                if (k < 0) m = -k;
                else m = 0;
                if (w.V(Dd)[h] <= c) c = w.V(Dd)[h] - 1;
                while (c >= m && A[k + c] == B[c]) c -= 1;
                if (e < 1) {  // edge is 2; alternatives 1 then 0
                    if (c <= w.V(Dd + 2)[k + 1]) {
                        e = 4; h = k + 1; Dd = Dd + 2;
                    } else if (c == w.V(Dd + 1)[k]) {
                        e = 0; h = k; Dd = Dd + 1;
                    } else {
                        w.V(Dd)[h] = c + 1;
                    }
                } else {  // edge is 0; alternatives 1/4 then 0
                    if (k == del) m = Dd;
                    else m = Dd - 2;
                    if (c <= w.V(m)[k + 1]) {
                        if (k == del) e = 4;
                        else e = 1;
                        h = k + 1;
                        Dd = m;
                    } else if (c == w.V(Dd - 1)[k]) {
                        e = 0; h = k; Dd = Dd - 1;
                    } else {
                        w.V(Dd)[h] = c + 1;
                    }
                }
            }
            m = w.H(Dd)[h];
            w.H(Dd)[h] = e;
            e = m;
            k = h;
        }

        // forward walk emitting the script (LAInterface.cpp:3353-3374)
        k = Dd = 0;
        e = w.H(Dd)[k];
        while (e != 3) {
            h = k - e;
            c = w.V(Dd)[k];
            if (e > 1) h += 3;
            else if (e == 0) Dd += 1;
            else Dd += 2;
            if (h > k) script.push_back(bpc + c);
            else if (h < k) script.push_back(apc - (c + k));
            k = h;
            e = w.H(Dd)[h];
        }
    }
}

// getAlignmentTags' column emission for one window-local script
// (LAInterface.cpp:3829-3871), writing gap-code rows.
static int emit_rows(const uint8_t *A, int M, const uint8_t *B, int N,
                     const int32_t *script, int slen,
                     uint8_t *ra, uint8_t *rb) {
    (void)N;
    int i = 1, j = 1, o = 0;
    for (int c = 0; c < slen; c++) {
        int p = script[c];
        if (p < 0) {
            p = -p;
            while (i != p) {
                ra[o] = A[i - 1];
                rb[o] = B[j - 1];
                o++; i++; j++;
            }
            ra[o] = kGap;
            rb[o] = B[j - 1];
            o++; j++;
        } else {
            while (j != p) {
                ra[o] = A[i - 1];
                rb[o] = B[j - 1];
                o++; i++; j++;
            }
            ra[o] = A[i - 1];
            rb[o] = kGap;
            o++; i++;
        }
    }
    while (i <= M) {
        ra[o] = A[i - 1];
        rb[o] = B[j - 1];
        o++; i++; j++;
    }
    return o;
}

}  // namespace

extern "C" {

// Batched exact window alignment over padded context buffers.
//   abuf/bbuf: concatenated per-alignment context bytes (bases 0..3 plus
//              4-sentinels, mirroring Load_Subread's framing)
//   a_ptr/b_ptr: per-window absolute index of the window start in abuf/bbuf
//   a_len/b_len: window lengths M/N
//   a_avail/b_avail: valid bytes available before the window start
//   out_a/out_b: row buffers; window n writes at out_off[n], capacity
//                a_len[n] + b_len[n]
//   out_len: emitted row length per window
// Returns 0 on success, -1 on invalid input.
int dalign_rows_batch(const uint8_t *abuf, const uint8_t *bbuf,
                      const int64_t *a_ptr, const int32_t *a_len,
                      const int32_t *a_avail,
                      const int64_t *b_ptr, const int32_t *b_len,
                      const int32_t *b_avail,
                      int n_windows,
                      uint8_t *out_a, uint8_t *out_b,
                      const int64_t *out_off, int32_t *out_len) {
    WaveArena arena;
    std::vector<int32_t> script;
    for (int n = 0; n < n_windows; n++) {
        const int M = a_len[n], N = b_len[n];
        if (M < 0 || N < 0 || a_avail[n] < 1 || b_avail[n] < 1) return -1;
        const uint8_t *A = abuf + a_ptr[n];
        const uint8_t *B = bbuf + b_ptr[n];
        uint8_t *ra = out_a + out_off[n];
        uint8_t *rb = out_b + out_off[n];
        if (M == 0 && N == 0) { out_len[n] = 0; continue; }
        script.clear();
        iter_np_window(A, M, a_avail[n], B, N, arena, script);
        out_len[n] = emit_rows(A, M, B, N, script.data(),
                               static_cast<int>(script.size()), ra, rb);
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded variants + diffs-only path (the map stage's fill_window_diffs
// needs only the per-window edit-column count, not materialized rows).
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

namespace {

// mismatch-column count of one window's alignment: every script entry is an
// indel column; paired stretches contribute their base mismatches
// (getAlignmentTags pairs residues between script points).
static int count_diffs(const uint8_t *A, int M, const uint8_t *B, int N,
                       const int32_t *script, int slen) {
    (void)N;
    int i = 1, j = 1, d = 0;
    for (int c = 0; c < slen; c++) {
        int p = script[c];
        if (p < 0) {
            p = -p;
            while (i != p) {
                d += (A[i - 1] != B[j - 1]);
                i++; j++;
            }
            d++;  // gap column
            j++;
        } else {
            while (j != p) {
                d += (A[i - 1] != B[j - 1]);
                i++; j++;
            }
            d++;
            i++;
        }
    }
    while (i <= M) {
        d += (A[i - 1] != B[j - 1]);
        i++; j++;
    }
    return d;
}

}  // namespace

extern "C" {

// dalign_rows_batch with a worker pool (windows are independent).
int dalign_rows_batch_mt(const uint8_t *abuf, const uint8_t *bbuf,
                         const int64_t *a_ptr, const int32_t *a_len,
                         const int32_t *a_avail,
                         const int64_t *b_ptr, const int32_t *b_len,
                         const int32_t *b_avail,
                         int64_t n_windows,
                         uint8_t *out_a, uint8_t *out_b,
                         const int64_t *out_off, int32_t *out_len,
                         int32_t n_threads) {
    if (n_windows <= 0) return 0;
    std::atomic<int> bad(0);
    std::atomic<int64_t> next(0);
    const int64_t kChunk = 256;
    auto worker = [&]() {
        WaveArena arena;
        std::vector<int32_t> script;
        while (true) {
            const int64_t c0 = next.fetch_add(kChunk);
            if (c0 >= n_windows) break;
            const int64_t c1 = std::min(c0 + kChunk, n_windows);
            for (int64_t n = c0; n < c1; n++) {
                const int M = a_len[n], N = b_len[n];
                if (M < 0 || N < 0 || a_avail[n] < 1 || b_avail[n] < 1) {
                    bad.store(1);
                    return;
                }
                const uint8_t *A = abuf + a_ptr[n];
                const uint8_t *B = bbuf + b_ptr[n];
                if (M == 0 && N == 0) { out_len[n] = 0; continue; }
                script.clear();
                iter_np_window(A, M, a_avail[n], B, N, arena, script);
                out_len[n] = emit_rows(A, M, B, N, script.data(),
                                       static_cast<int>(script.size()),
                                       out_a + out_off[n], out_b + out_off[n]);
            }
        }
    };
    int64_t nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_windows) nt = n_windows;
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int64_t t = 0; t < nt; t++) threads.emplace_back(worker);
        for (auto &th : threads) th.join();
    }
    return bad.load() ? -1 : 0;
}

// Fill per-record padded context interiors (Load_Subread semantics — the
// sentinels are pre-written by the caller): one memcpy per A context, one
// memcpy or reverse-complement per B context.  The equivalent Python loop
// at 10^5 records was ~20% of map+consensus wall.
int64_t build_contexts(const uint8_t *a_cat, const int64_t *a_lo,
                       const int64_t *a_hi, const int64_t *a_dst,
                       const uint8_t *b_cat, const int64_t *b_lo,
                       const int64_t *b_hi, const int64_t *b_dst,
                       const uint8_t *rc, int64_t n,
                       uint8_t *abuf, uint8_t *bbuf) {
    static const uint8_t comp[4] = {3, 2, 1, 0};
    for (int64_t r = 0; r < n; r++) {
        memcpy(abuf + a_dst[r], a_cat + a_lo[r],
               static_cast<size_t>(a_hi[r] - a_lo[r]));
        const int64_t nb = b_hi[r] - b_lo[r];
        if (rc[r]) {
            const uint8_t *s = b_cat + b_lo[r];
            uint8_t *d = bbuf + b_dst[r];
            for (int64_t i = 0; i < nb; i++) d[i] = comp[s[nb - 1 - i] & 3];
        } else {
            memcpy(bbuf + b_dst[r], b_cat + b_lo[r],
                   static_cast<size_t>(nb));
        }
    }
    return 0;
}

// In-place dense compaction of the capacity-strided row buffers: window w's
// rows move from out_off[w] down to the running dense offset.  Offsets are
// the cumulative capacities (out_len[w] <= capacity), so dst <= out_off[w]
// always holds and a single forward memmove pass is safe.  Returns the
// dense total length.
int64_t dalign_compact_rows(uint8_t *out_a, uint8_t *out_b,
                            const int64_t *out_off, const int32_t *out_len,
                            int64_t n_windows) {
    int64_t dst = 0;
    for (int64_t w = 0; w < n_windows; w++) {
        const int64_t L = out_len[w];
        if (out_off[w] != dst && L > 0) {
            memmove(out_a + dst, out_a + out_off[w], L);
            memmove(out_b + dst, out_b + out_off[w], L);
        }
        dst += L;
    }
    return dst;
}

// Diffs-only batch: same exact wave, but only the per-window mismatch-column
// count comes back — no row materialization, no output buffers.
int dalign_diffs_batch(const uint8_t *abuf, const uint8_t *bbuf,
                       const int64_t *a_ptr, const int32_t *a_len,
                       const int32_t *a_avail,
                       const int64_t *b_ptr, const int32_t *b_len,
                       const int32_t *b_avail,
                       int64_t n_windows, int32_t *out_diffs,
                       int32_t n_threads) {
    if (n_windows <= 0) return 0;
    std::atomic<int> bad(0);
    std::atomic<int64_t> next(0);
    const int64_t kChunk = 256;
    auto worker = [&]() {
        WaveArena arena;
        std::vector<int32_t> script;
        while (true) {
            const int64_t c0 = next.fetch_add(kChunk);
            if (c0 >= n_windows) break;
            const int64_t c1 = std::min(c0 + kChunk, n_windows);
            for (int64_t n = c0; n < c1; n++) {
                const int M = a_len[n], N = b_len[n];
                if (M < 0 || N < 0 || a_avail[n] < 1 || b_avail[n] < 1) {
                    bad.store(1);
                    return;
                }
                const uint8_t *A = abuf + a_ptr[n];
                const uint8_t *B = bbuf + b_ptr[n];
                if (M == 0 && N == 0) { out_diffs[n] = 0; continue; }
                script.clear();
                iter_np_window(A, M, a_avail[n], B, N, arena, script);
                out_diffs[n] = count_diffs(A, M, B, N, script.data(),
                                           static_cast<int>(script.size()));
            }
        }
    };
    int64_t nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_windows) nt = n_windows;
    if (nt == 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int64_t t = 0; t < nt; t++) threads.emplace_back(worker);
        for (auto &th : threads) th.join();
    }
    return bad.load() ? -1 : 0;
}

}  // extern "C"
