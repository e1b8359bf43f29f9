// DW_banded O(ND) wavefront aligner (forward wave + backtrack), for Hopper.
//
// Replaces the XLA programs hinge_tpu/ops/wavefront.py::_wave_forward
// (:75) and ::_wave_backtrack (:179); the plain torch twin is
// hinge_tpu_torch/ops/wavefront.py::wave_forward_ref + wave_backtrack_ref.
// Outputs (px/py at [0, 2*d_fin+2), aligned, d_fin, k_fin, x_fin) are
// bit-identical to the twin's.
//
// Per window and step d (the twin's body, line for line):
//   live only while d < dmax = (int)(0.3f * (m + n)) and the band
//   max_k - min_k <= 2 * band_tolerance (else abort, unaligned);
//   slot s < kb holds diagonal k = min_k + 2s while 2s <= max_k - min_k;
//   x0 = V[k+1] when k == min_k || (k != max_k && V[k-1] < V[k+1]),
//   else V[k-1] + 1; the snake runs from (x0, x0 - k) in chunks of 16
//   compares from a base clipped into [0, L-1], as the twin's;
//   the first slot in ascending order with x >= m or y >= n ends the
//   window; otherwise the band shrinks to the slots with
//   x + y >= best_m - band_tolerance, widened by one on each side.
//
// What bounds it on this card: the latency of each window's chain of
// dependent steps, and the issue and shared-memory traffic the steps
// take; not bytes.  A ladder window of ~900 bp runs ~55-65 dependent
// steps of ~8 live diagonals and ~3 snake compares a diagonal; the
// function's own bytes and operations (the bound chip_smoke.py computes)
// are a few percent of what the schedulers issue.  A warp per window with
// every lane running ceil(kb/32) band slots and a byte-wide snake spent
// most of its issue on dead slots and clamps, and its 4.4 KB V row capped
// the windows resident on an SM at ~32.  A warp of this design steps at
// the pace of the slowest of its windows: each step waits on the longest
// snake and the widest band among them.
// What the design does about it:
// - A window is a group of G lanes, 8, 16 or 32 (4, 2 or 1 windows a
//   warp).  The wrapper (ops/wavefront.py::k3_lanes) takes the widest
//   group while the launch has few windows an SM, where each window's
//   chain is the time, and 8 once the card is full, where idle lanes
//   cost issue.  A group loops over the slots its live band has, a
//   runtime bound, so a wide band (up to the 2*band_tolerance abort)
//   takes more rounds and a narrow one costs one.
// - The groups of a warp step together: every lane runs every step (a
//   finished group with no slots) and the group reductions (first
//   finishing slot, best_m, the new band edges) are xor shuffles under
//   the warp's one mask.  Per-group masks let the compiler split the warp
//   into groups that then issue one after another.
// - No V row: each step's live x values are written once, as int16, to a
//   compact history stream (the row's values, then its min_k and max_k),
//   and the next step reads V[k-1], V[k+1] from the previous row.  With
//   band_tolerance >= 0 every value the tie rule uses lies in the
//   previous row's live slots (the row maximum of x + y rises by at least
//   one a step, so the band never empties).  x <= m + 1 < L, and the
//   wrapper's limits keep L < 32768, so int16 holds V exactly.
// - The stream's last R entries (K3_RING, 64) sit in a ring in shared
//   memory; every entry is also written to the window's global scratch.
//   A step reads the previous row from the ring when both rows fit it,
//   else from the scratch (a band wider than ~30 slots).  After the wave
//   the stream's tail goes into q and t's space, so the backtrack, a
//   serial walk of ~d_fin steps on one lane, reads shared memory; a slot
//   outside row d-1's live slots reads 0, as the twin's history does.
// - The snake compares 16 bytes as four 32-bit words formed by funnel
//   shifts from aligned shared-memory words, the first word alone first
//   (most snakes end in it); __ffs of q ^ t gives the first mismatch.
//   Where the twin's base is clipped (a base below 0 or a chunk reaching
//   past L-1) it compares byte by byte as the twin does.
// - 2.2 KB of shared memory a window at L 1024, so ~96 windows resident
//   an SM.  Blocks are persistent: the grid is what fits on the card at
//   once and each group takes windows slot, slot + slots, ...; the global
//   scratch is one history stream a resident group, so it scales with the
//   card, not with the batch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SNAKE = 16;
constexpr int BIG = 1 << 30;
constexpr size_t SMEM_MAX = 232448;
constexpr int MAX_THREADS = 128;

__host__ __device__ __forceinline__ size_t align16(size_t v) {
    return (v + 15) & ~size_t(15);
}

// shared bytes of one window: q and t (a word of slack past L for the
// word-wide snake) and the history ring
__host__ __device__ __forceinline__ size_t window_smem(int L, int R) {
    return 2 * align16(size_t(L) + 4) + align16(size_t(R) * 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// live slots of a row with band [min_k, max_k]
__device__ __forceinline__ int row_slots(int min_k, int max_k, int kb) {
    const int width = max_k - min_k;
    return width < 0 ? 0 : min(kb, (width >> 1) + 1);
}

// first mismatch of q[a..a+16) against t[b..b+16), both inside [0, L):
// the first word alone first, since most snakes end in it (an off
// diagonal matches a base one time in four), then the other three
__device__ __forceinline__ int match16(const uint8_t* qs, const uint8_t* ts,
                                       int a, int b) {
    const uint32_t* Q = reinterpret_cast<const uint32_t*>(qs) + (a >> 2);
    const uint32_t* T = reinterpret_cast<const uint32_t*>(ts) + (b >> 2);
    const unsigned sa = (a & 3) * 8, sb = (b & 3) * 8;
    const uint32_t q1 = Q[1], t1 = T[1];
    const uint32_t d0 = __funnelshift_r(Q[0], q1, sa) ^ __funnelshift_r(T[0], t1, sb);
    if (d0) return (__ffs(d0) - 1) >> 3;
    uint32_t qw[4], tw[4];
    qw[0] = q1;
    tw[0] = t1;
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        qw[i] = Q[i + 1];
        tw[i] = T[i + 1];
    }
    const uint32_t d1 = __funnelshift_r(qw[0], qw[1], sa) ^ __funnelshift_r(tw[0], tw[1], sb);
    const uint32_t d2 = __funnelshift_r(qw[1], qw[2], sa) ^ __funnelshift_r(tw[1], tw[2], sb);
    const uint32_t d3 = __funnelshift_r(qw[2], qw[3], sa) ^ __funnelshift_r(tw[2], tw[3], sb);
    return d1 ? 4 + ((__ffs(d1) - 1) >> 3)
              : d2 ? 8 + ((__ffs(d2) - 1) >> 3)
                   : d3 ? 12 + ((__ffs(d3) - 1) >> 3) : SNAKE;
}

// One chunk of SNAKE compares of the snake at (a, b): word-wide where
// the chunk lies inside [0, L), else byte by byte from the base clipped
// into [0, L-1], as the twin's.  A snake stops at its first mismatch (the
// pads 4 and 5 never match).
__device__ __forceinline__ bool chunk_fast(int a, int b, int L) {
    return a >= 0 && b >= 0 && a <= L - SNAKE && b <= L - SNAKE;
}

__device__ __forceinline__ int chunk(const uint8_t* qs, const uint8_t* ts,
                                     int L, int a, int b) {
    if (chunk_fast(a, b, L)) return match16(qs, ts, a, b);
    const int bx = clampi(a, 0, L - 1), by = clampi(b, 0, L - 1);
    int c = 0;
    for (; c < SNAKE; ++c)
        if (qs[min(bx + c, L - 1)] != ts[min(by + c, L - 1)]) break;
    return c;
}

// match run from (x0, y0): chunks of SNAKE compares until a mismatch
__device__ __forceinline__ int snake(const uint8_t* qs, const uint8_t* ts,
                                     int L, int x0, int y0) {
    int run = 0;
    for (;;) {
        const int c = chunk(qs, ts, L, x0 + run, y0 + run);
        run += c;
        if (c < SNAKE) return run;
    }
}

// min / max over a group of G lanes: xor shuffles under the warp's one
// mask (per-group masks would make the compiler split the warp)
template <int G>
__device__ __forceinline__ int group_min(unsigned wmask, int v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(wmask, v, o));
    return v;
}

template <int G>
__device__ __forceinline__ int group_max(unsigned wmask, int v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(wmask, v, o));
    return v;
}

__device__ __forceinline__ int wrap(int r, int R) {
    return r < 0 ? r + R : (r >= R ? r - R : r);
}

// x0 of the slot on diagonal k at step d > 0: the tie rule on the
// previous row, read from the ring (RING) or from the scratch
template <bool RING>
__device__ __forceinline__ int x0_of(int k, int min_k, int max_k, int pmin,
                                     int rprev, int poff, int R,
                                     const int16_t* ring, const int16_t* gl) {
    const int i = (k - 1 - pmin) >> 1;  // -1 .. the previous row's slots
    int vm1, vp1;
    if (RING) {
        const int r = wrap(rprev + i, R);
        vm1 = ring[r];
        vp1 = ring[r + 1 == R ? 0 : r + 1];
    } else {
        vm1 = gl[poff + max(i, 0)];
        vp1 = gl[poff + i + 1];
    }
    const bool right = k == min_k || (k != max_k && vm1 < vp1);
    return right ? vp1 : vm1 + 1;
}

// The path points from the history stream, walking d_fin .. 0 (the
// twin's backtrack): stream positions from lo2 on are in shared memory
// (all of them when FITS), the rest in the scratch.
template <bool FITS>
__device__ __forceinline__ void backtrack(const int16_t* qt16, const int16_t* gl,
                                          int lo2, int total, int kb, int d_fin,
                                          int k_fin, int x_fin, int32_t* pxw,
                                          int32_t* pyw) {
    auto rd = [&](int p) -> int {
        return FITS ? qt16[p] : (p >= lo2 ? qt16[p - lo2] : gl[p]);
    };
    int mk = rd(total - 2), xk = rd(total - 1);
    int S = total - 2 - row_slots(mk, xk, kb);  // row d's first value
    int k = k_fin, x2 = x_fin;
    for (int d = d_fin; d >= 0; --d) {
        int x1 = 0, vm1 = 0, vp1 = 0, mk1 = 0, xk1 = 0, S1 = 0;
        bool right = true;
        if (d > 0) {
            mk1 = rd(S - 2);
            xk1 = rd(S - 1);
            const int n1 = row_slots(mk1, xk1, kb);
            S1 = S - 2 - n1;
            // floor division by 2 (arithmetic shift), as the twin's; a
            // slot outside row d-1's live slots reads 0
            const int lm = clampi((k - 1 - mk1) >> 1, 0, kb - 1);
            const int lp = clampi((k + 1 - mk1) >> 1, 0, kb - 1);
            vm1 = lm < n1 ? rd(S1 + lm) : 0;
            vp1 = lp < n1 ? rd(S1 + lp) : 0;
            right = k == mk || (k != xk && vm1 < vp1);
            x1 = right ? vp1 : vm1 + 1;
        }
        const int pos = 2 * d;
        pxw[pos] = x1;
        pyw[pos] = x1 - k;
        pxw[pos + 1] = x2;
        pyw[pos + 1] = x2 - k;
        if (d > 0) {
            k = right ? k + 1 : k - 1;
            x2 = right ? vp1 : vm1;
            mk = mk1;
            xk = xk1;
            S = S1;
        }
    }
}

template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
wave_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  int L, const int32_t* __restrict__ m_,
                  const int32_t* __restrict__ n_, int B, int bt, int max_d,
                  int kb, int wb, int R, long long hps,
                  int16_t* __restrict__ hist, int32_t* __restrict__ px,
                  int32_t* __restrict__ py, uint8_t* __restrict__ aligned_o,
                  int32_t* __restrict__ d_fin_o, int32_t* __restrict__ k_fin_o,
                  int32_t* __restrict__ x_fin_o) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int grp = threadIdx.x / G;
    // the warp's lanes that hold a window group; the warp steps them together
    const unsigned wmask = __ballot_sync(FULL, grp < wb);
    if (grp >= wb) return;  // whole groups leave; no block-wide barrier follows
    const int g = threadIdx.x % G;

    const int QS = static_cast<int>(align16(size_t(L) + 4));
    unsigned char* base = smem + size_t(grp) * window_smem(L, R);
    uint8_t* qs = base;
    uint8_t* ts = base + QS;
    int16_t* qt16 = reinterpret_cast<int16_t*>(base);  // q and t's space, for the backtrack
    int16_t* ring = reinterpret_cast<int16_t*>(base + 2 * QS);
    const int slots = gridDim.x * wb;
    const int slot = blockIdx.x * wb + grp;
    int16_t* gl = hist + size_t(slot) * size_t(hps);
    const int band_size = 2 * bt;
    const int W = 2 * max_d + 2;
    const bool vec = (L & 15) == 0 &&
                     ((reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(t)) & 15) == 0;

    for (int w = slot; __any_sync(wmask, w < B); w += slots) {
        const bool has = w < B;
        if (has) {
            const uint8_t* qg = q + size_t(w) * L;
            const uint8_t* tg = t + size_t(w) * L;
            if (vec) {
                const uint4* q4 = reinterpret_cast<const uint4*>(qg);
                const uint4* t4 = reinterpret_cast<const uint4*>(tg);
                uint4* qs4 = reinterpret_cast<uint4*>(qs);
                uint4* ts4 = reinterpret_cast<uint4*>(ts);
#pragma unroll 4
                for (int i = g; i < (L >> 4); i += G) {
                    qs4[i] = __ldg(q4 + i);
                    ts4[i] = __ldg(t4 + i);
                }
            } else {
                for (int i = g; i < L; i += G) {
                    qs[i] = qg[i];
                    ts[i] = tg[i];
                }
            }
        }
        __syncwarp(wmask);

        const int m = has ? m_[w] : 0, n = has ? n_[w] : 0;
        const int steps =
            min(max_d, static_cast<int>(0.3f * static_cast<float>(m + n)));
        int best_m = -1, min_k = 0, max_k = 0;
        int pmin = 0, pn = 0, poff = 0, rprev = 0;  // the previous row
        int off = 0, roff = 0;  // this row: stream position, ring index
        bool run = has, aligned = false;
        int d_fin = 0, k_fin = 0, x_fin = 0;

        // every lane of the warp runs every step, a finished group with no
        // slots, so the groups stay converged at the reductions
        for (int d = 0; __any_sync(wmask, run); ++d) {
            // band overflow: unaligned (DW_banded.c:131-137)
            if (d >= steps || max_k - min_k > band_size) run = false;
            const int nl = run ? row_slots(min_k, max_k, kb) : 0;
            // the previous row is read from the ring when both rows fit
            // it, else from the scratch; a row wider than the ring keeps
            // its last R entries there, from slot ring_from on
            const bool ring_prev = pn + nl + 4 <= R;
            const int ring_from = nl + 2 - R;
            const int r0 = max(ring_from, 0);
            int rw = roff + r0;
            while (rw >= R) rw -= R;
            int fin = BIG, mu = -BIG, x_own = 0;
            auto record = [&](int s, int x) {
                const int k = min_k + 2 * s;
                if (s >= ring_from) ring[wrap(rw + (s - r0), R)] = static_cast<int16_t>(x);
                gl[off + s] = static_cast<int16_t>(x);
                if (fin == BIG && (x >= m || x - k >= n)) fin = s;
                mu = max(mu, 2 * x - k);
                if (s == g) x_own = x;
            };
            auto slots_from = [&](auto x0_at) {
                for (int s = g; s < nl; s += G) {
                    const int k = min_k + 2 * s, x0 = x0_at(k);
                    record(s, x0 + ((x0 < m && x0 - k < n) ? snake(qs, ts, L, x0, x0 - k) : 0));
                }
            };
            if (d == 0) {  // V is all zeros: x0 = 0 on the one diagonal
                slots_from([](int) { return 0; });
            } else if (ring_prev) {
                slots_from([&](int k) {
                    return x0_of<true>(k, min_k, max_k, pmin, rprev, poff, R, ring, gl);
                });
            } else {
                slots_from([&](int k) {
                    return x0_of<false>(k, min_k, max_k, pmin, rprev, poff, R, ring, gl);
                });
            }
            if (run && g == 0) {
                ring[wrap(rw + (nl - r0), R)] = static_cast<int16_t>(min_k);
                ring[wrap(rw + (nl + 1 - r0), R)] = static_cast<int16_t>(max_k);
                gl[off + nl] = static_cast<int16_t>(min_k);
                gl[off + nl + 1] = static_cast<int16_t>(max_k);
            }
            __syncwarp(wmask);  // the row's x visible to the group
            const int fs = group_min<G>(wmask, fin);
            const int bm = group_max<G>(wmask, mu);
            // band update (DW_banded.c:188-201)
            const int best_m2 = max(best_m, bm);
            int kmin = BIG, kmax = -BIG;
            if (fs == BIG) {
                for (int s = g; s < nl; s += G) {
                    const int x = s == g ? x_own
                                  : s >= ring_from ? ring[wrap(rw + (s - r0), R)]
                                                   : gl[off + s];
                    const int k = min_k + 2 * s;
                    if (2 * x - k >= best_m2 - bt) {
                        kmin = min(kmin, k);
                        kmax = max(kmax, k);
                    }
                }
            }
            kmin = group_min<G>(wmask, kmin);
            kmax = group_max<G>(wmask, kmax);
            if (run) {
                int rnext = roff + nl + 2;
                while (rnext >= R) rnext -= R;
                if (fs != BIG) {
                    const int f = fs;
                    aligned = true;
                    run = false;
                    d_fin = d;
                    k_fin = min_k + 2 * f;
                    x_fin = f >= ring_from ? ring[wrap(rw + (f - r0), R)] : gl[off + f];
                } else {
                    const bool keep = kmin != BIG;
                    const int new_min = keep ? kmin : max_k;
                    const int new_max = keep ? kmax : min_k;
                    pmin = min_k;
                    pn = nl;
                    poff = off;
                    rprev = roff;
                    min_k = new_min - 1;
                    max_k = new_max + 1;
                    best_m = best_m2;
                }
                off += nl + 2;
                roff = rnext;
            }
            __syncwarp(wmask);  // this row's values, before the next row reads them
        }

        // the stream's tail, as much as fits, into q and t's space: the
        // scratch part in 16-byte pieces (hps is a multiple of 8), then the
        // ring's part over it, so the backtrack reads shared memory
        const int total = off, lo = off - R, rt = roff;
        const int lo2 = max(0, total - QS + 16) & ~7, hi = max(lo, lo2);
        if (aligned) {
            const int4* src = reinterpret_cast<const int4*>(gl + lo2);
            int4* dst = reinterpret_cast<int4*>(qt16);
#pragma unroll 4
            for (int i = g; i < (hi - lo2 + 7) >> 3; i += G) dst[i] = src[i];
        }
        __syncwarp(wmask);
        if (aligned)
            for (int p = hi + g; p < total; p += G)
                qt16[p - lo2] = ring[wrap(rt + (p - total), R)];
        __syncwarp(wmask);
        if (has && g == 0) {
            int32_t* pxw = px + size_t(w) * W;
            int32_t* pyw = py + size_t(w) * W;
            aligned_o[w] = aligned ? 1 : 0;
            d_fin_o[w] = d_fin;
            k_fin_o[w] = k_fin;
            x_fin_o[w] = x_fin;
            if (!aligned) pxw[0] = pxw[1] = pyw[0] = pyw[1] = 0;
        }
        if (aligned && g == 0) {
            int32_t* pxw = px + size_t(w) * W;
            int32_t* pyw = py + size_t(w) * W;
            if (lo2 == 0)
                backtrack<true>(qt16, gl, lo2, total, kb, d_fin, k_fin, x_fin, pxw, pyw);
            else
                backtrack<false>(qt16, gl, lo2, total, kb, d_fin, k_fin, x_fin, pxw, pyw);
        }
        __syncwarp(wmask);  // the backtrack is done with q and t's space
    }
}

template <int G>
cudaError_t prepare(size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(
        wave_align_kernel<G>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute(wave_align_kernel<G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    return e;
}

template <int G>
int resident(int threads, size_t smem) {
    cudaError_t e = prepare<G>(smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, wave_align_kernel<G>, threads, smem);
    return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

template <int G>
int launch(const uint8_t* q, const uint8_t* t, int L, const int32_t* m,
           const int32_t* n, int B, int bt, int max_d, int kb, int wb, int R,
           long long hps, int grid, int16_t* hist, int32_t* px, int32_t* py,
           uint8_t* aligned, int32_t* d_fin, int32_t* k_fin, int32_t* x_fin,
           cudaStream_t stream) {
    const size_t smem = size_t(wb) * window_smem(L, R);
    const cudaError_t e = prepare<G>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = (wb * G + 31) / 32 * 32;
    wave_align_kernel<G><<<grid, threads, smem, stream>>>(
        q, t, L, m, n, B, bt, max_d, kb, wb, R, hps, hist, px, py, aligned,
        d_fin, k_fin, x_fin);
    return static_cast<int>(cudaGetLastError());
}

bool plan_ok(int lanes, int wb, long long L, int R) {
    return (lanes == 8 || lanes == 16 || lanes == 32) && wb >= 1 &&
           wb * lanes <= MAX_THREADS && L >= 1 && L < 32768 && R >= 6 &&
           size_t(wb) * window_smem(static_cast<int>(L), R) <= SMEM_MAX;
}

}  // namespace

// Blocks of `wb` windows (of `lanes` lanes each, ring R entries) that fit
// on the current device at once, or minus a cudaError.
extern "C" int hinge_wave_align_resident(int lanes, int wb, long long L, int R) {
    if (!plan_ok(lanes, wb, L, R)) return -static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = size_t(wb) * window_smem(static_cast<int>(L), R);
    const int threads = (wb * lanes + 31) / 32 * 32;
    switch (lanes) {
        case 8: return resident<8>(threads, smem);
        case 16: return resident<16>(threads, smem);
        default: return resident<32>(threads, smem);
    }
}

// The wrapper (ops/wavefront.py::launch_k3_at) plans the launch
// (k3_plan: lanes, wb, R, hps) and sizes `hist` to grid * wb * hps int16.
extern "C" int hinge_wave_align(const void* q, const void* t, long long L,
                                const void* m, const void* n, int B, int bt,
                                int max_d, int kb, int lanes, int wb, int R,
                                long long hps, int grid, void* hist, void* px,
                                void* py, void* aligned, void* d_fin,
                                void* k_fin, void* x_fin, void* stream) {
    if (B <= 0) return 0;
    if (kb < 1 || kb > 256 || max_d < 1 || grid < 1 || hps < 1 ||
        (hps & 7) || !plan_ok(lanes, wb, L, R))
        return static_cast<int>(cudaErrorInvalidValue);
#define HINGE_WAVE_CASE(G)                                                   \
    case G:                                                                  \
        return launch<G>(static_cast<const uint8_t*>(q),                     \
                         static_cast<const uint8_t*>(t), static_cast<int>(L), \
                         static_cast<const int32_t*>(m),                     \
                         static_cast<const int32_t*>(n), B, bt, max_d, kb,   \
                         wb, R, hps, grid, static_cast<int16_t*>(hist),      \
                         static_cast<int32_t*>(px), static_cast<int32_t*>(py), \
                         static_cast<uint8_t*>(aligned),                     \
                         static_cast<int32_t*>(d_fin),                       \
                         static_cast<int32_t*>(k_fin),                       \
                         static_cast<int32_t*>(x_fin),                       \
                         static_cast<cudaStream_t>(stream));
    switch (lanes) {
        HINGE_WAVE_CASE(8)
        HINGE_WAVE_CASE(16)
        HINGE_WAVE_CASE(32)
    }
#undef HINGE_WAVE_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
