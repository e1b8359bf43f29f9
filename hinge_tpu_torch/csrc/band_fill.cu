// Banded Needleman-Wunsch fill (unit costs, band width 256) for Hopper.
//
// Replaces the Pallas TPU kernel hinge_tpu/ops/pallas_band_nw.py::_band_fill
// (body `kernel`, pallas_call at :166); the plain torch twin is
// hinge_tpu_torch/ops/band_nw.py::band_fill_ref.  The move codes it writes
// are bit-identical to both.
//
// Recurrence, band coordinate k = j - i + 128, one DP row i per step:
//   diag  (i-1, j-1) -> same lane k
//   up    (i-1, j)   -> lane k+1
//   left  (i, j-1)   -> in-row prefix-min:   C = min(E, k + cummin(E - k))
//   sub   q[i-1] vs t[j-1]
// Lane j == 0 gets cost i and move up; lanes with j outside [1, n] get INF
// and move 3; rows i > m keep the row-m cost row (frozen), their moves are
// still written.  Ties: 2 if C < E, else 0 if diag <= up, else 1.
//
// What bounds it on this card: every one of the B x mrows x 256 band cells
// is computed and its move byte written, so the floor is the larger of the
// move bytes over HBM bandwidth and the cell operations over the issue
// rate of the type that holds them.  A cell needs about 8 integer
// operations (the base compare, the diag add, three add-mins for up, the
// left scan and C, two tests and the move); in 16-bit halves one 16x2 or
// DPX instruction does two cells, and then the move bytes bound it.  Each
// row also carries a serial chain: the up shift and a scan across the band.
//
// What the design does about it (`band_fill_kernel`):
// - Two band cells per 32-bit register as signed 16-bit halves, driven by
//   Hopper's DPX instructions (__viaddmin_s16x2 = min(a + b, c) per half,
//   __viaddmax_u16x2) and the 16x2 mins (__vmins2, __vminu2): one
//   instruction does two cells' add and min.  INF is 0x7000, far above
//   every finite cost and below the 16-bit limit after the scan's offsets,
//   so every comparison orders as with the twin's 1 << 24.
// - Costs stay small for windows of any length: every REBASE rows (past
//   the rows that hold the j == 0 cell) the window's least finite cost is
//   taken off its finite costs, INF staying INF.  Moves depend only on
//   differences of finite costs and on their order against INF, so they
//   do not change.  Neighbouring finite cells of a band row differ by at
//   most 1 and a row's least cost grows by at most 1 a row, so finite
//   costs stay below REBASE + 2 * 256.
// - Two windows per warp, 16 lanes x 16 cells each: one round of shuffles
//   (the up shift, the 5-step exclusive scan) serves both windows.
// - A lane's register p holds its cells p and p + 8, so "up" of register
//   p is register p + 1 and the in-lane left scan is one 16x2 chain of 7
//   steps plus a fix-up of the high halves; only one register per row
//   needs a byte permute for "up".
// - t is a per-lane sliding window of 16 halves in registers, laid out
//   the same way; its registers rotate through a group of 8 rows, so a
//   row refills one register (from lane + 1's, in the same shuffle as
//   "up"; the last lane reads t itself).  The band edges ride in t's high
//   byte (0xFF = j outside [1, n], 0x7F = the j == 0 cell), so the keep
//   mask of a register costs one prmt.
// - Groups of 8 rows whose cells all lie inside [1, n] and before m run
//   without the masks and the frozen-row select.
// - q bytes and the last lane's t byte are loaded a group of 8 rows ahead,
//   off the row chain; no global load sits on the chain.
// - Each lane writes its 16 move bytes of a row as one 16-byte store.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BW = 256;
constexpr int HB = BW / 2;
constexpr unsigned FULL = 0xffffffffu;

constexpr int N_WARPS = 4;            // 8 windows per block
constexpr int N_PER = 16;             // cells per lane
constexpr int N_PAIRS = N_PER / 2;
constexpr int GROUP = 8;              // rows per prefetch group = t rotation
constexpr int REBASE = 512;           // rows between rebases of the costs
constexpr unsigned INF16 = 0x7000u;   // INF in one half
constexpr unsigned INF2 = INF16 | (INF16 << 16);
constexpr unsigned ONES = 0x00010001u;
constexpr unsigned T_OUT = 0xFF00u;   // t half for j outside [1, n]
constexpr unsigned T_J0 = 0x7F00u;    // t half for the j == 0 cell
constexpr unsigned Q_PAD = 250u;      // the twin's q pad past m

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned s) {
    unsigned d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
}
__device__ __forceinline__ unsigned sel(unsigned mask, unsigned a, unsigned b) {
    return (a & mask) | (b & ~mask);  // mask ? a : b, per bit
}
__device__ __forceinline__ unsigned vmin_u(unsigned a, unsigned b) {
    return __vminu2(a, b);
}
__device__ __forceinline__ unsigned vmin_s(unsigned a, unsigned b) {
    return __vmins2(a, b);
}
__device__ __forceinline__ unsigned vaddmin_s(unsigned a, unsigned b, unsigned c) {
    return __viaddmin_s16x2(a, b, c);
}
__device__ __forceinline__ unsigned vaddmax_u(unsigned a, unsigned b, unsigned c) {
    return __viaddmax_u16x2(a, b, c);
}

// the t half at position pos of window (t, n): flags outside [0, n)
__device__ __forceinline__ unsigned t_half(const uint8_t* tb, int n, int pos) {
    if (pos >= 0 && pos < n) return tb[pos];
    return pos == -1 ? T_J0 : T_OUT;
}

// Row kinds: EDGE rows may hold cells outside [1, n] or frozen rows
// (i > m); J0 rows are EDGE rows that also hold the j == 0 cell (i <= 128);
// INNER rows have every cell inside [1, n] and i <= m for both windows of
// the warp, so they skip the masks and the frozen-row select.
enum RowKind { EDGE, J0, INNER };

// One DP row i for this lane's 16 cells; returns the packed moves.
//
// Register p of a lane holds its cells p and p + 8 (lo, hi half), so that
// "up" (cell + 1) of register p is register p + 1, and only register 7
// needs the shuffled value.  The t window slides the same way: its
// physical registers rotate (logical register p is tw[(p + R) & 7], R the
// row's place in its group of 8), and one prmt per row refills the slot
// that falls out.
//
// The left scan runs in cost units: P[k] = min over cells l <= k of this
// lane of e'[l] + (k - l), with e'[l] = min(e[l], INF + l), the twin's
// clamp of cummin(e - k) at INF applied per term (it can bite only at
// k = 0, 1, since e <= INF + 1).  The lanes' tails go through an exclusive
// min-scan in units e - l, and C[k] = min(P[k], carry + k).
template <RowKind KIND, int R>
__device__ __forceinline__ uint4 fill_row(
        unsigned (&cost)[N_PAIRS], unsigned (&tw)[N_PAIRS], int i, int m,
        unsigned qb, unsigned t_top, int l16, int k0) {
#define TW(p) tw[((p) + R) & (N_PAIRS - 1)]
    // up shift and t slide in one shuffle: (cost[0].lo, tw[0].lo) of lane+1
    unsigned r = __shfl_down_sync(FULL, prmt(cost[0], TW(0), 0x5410), 1, 16);
    if (l16 == 15) r = INF16 | (t_top << 16);
    // the slot of logical register 0 becomes logical register 7 of this
    // row: cells 7 and 15 = the old cells 8 and lane+1's 0
    TW(0) = prmt(TW(0), r, 0x7632);
#undef TW
#define TW(p) tw[((p) + R + 1) & (N_PAIRS - 1)]

    const unsigned qp = qb * ONES;
    unsigned dg[N_PAIRS], e0[N_PAIRS], e[N_PAIRS], inv[N_PAIRS], pc[N_PAIRS];
    unsigned j0m[N_PAIRS];
#pragma unroll
    for (int p = 0; p < N_PAIRS; ++p) {
        const unsigned up = p < N_PAIRS - 1 ? cost[p + 1]
                                            : prmt(cost[0], r, 0x5432);
        const unsigned tp = TW(p);
        const unsigned sub = vmin_u(tp ^ qp, ONES);
        dg[p] = cost[p] + sub;                    // no carry: halves < 0x7fff
        e0[p] = vaddmin_s(up, ONES, dg[p]);       // min(diag, up + 1)
        unsigned ee = e0[p];
        if (KIND != INNER) {
            inv[p] = prmt(tp, 0, 0xBB99);         // 0xffff where t high byte < 0
            if (KIND == J0) {
                j0m[p] = prmt(tp << 1, 0, 0xBB99);  // 0x7F/0xFF high byte
                ee = sel(j0m[p], static_cast<unsigned>(i) * ONES, ee);
            }
            ee = sel(inv[p], INF2, ee);
        }
        e[p] = ee;
        unsigned es = ee;
        if (KIND != INNER && p < 2 && l16 == 0)  // cells 0 and 1
            es = vmin_s(es, (INF16 + p) | (0x7fffu << 16));
        pc[p] = p == 0 ? es : vaddmin_s(pc[p - 1], ONES, es);
    }
#undef TW
    // cells 8..15 take the run from cell 7
    const unsigned from7 = prmt(pc[N_PAIRS - 1], 0x7fffu, 0x1054);
#pragma unroll
    for (int p = 0; p < N_PAIRS; ++p)
        pc[p] = vaddmin_s(from7, static_cast<unsigned>(p + 1) << 16, pc[p]);

    // exclusive min-scan of the lanes' tails over the half-warp, in units
    // e - l, clamped at INF as the twin's cummin is
    const int tail = static_cast<int>(pc[N_PAIRS - 1] >> 16) - (k0 + N_PER - 1);
    int x = __shfl_up_sync(FULL, tail, 1, 16);
    if (l16 == 0) x = INT_MAX;
#pragma unroll
    for (int s = 1; s < 16; s <<= 1) {
        const int y = __shfl_up_sync(FULL, x, s, 16);
        if (l16 >= s) x = min(x, y);
    }
    const unsigned carry =
        static_cast<unsigned>(min(x, static_cast<int>(INF16)) + k0) * ONES;

    unsigned mvs[N_PAIRS];
    const bool live = i <= m;
#pragma unroll
    for (int p = 0; p < N_PAIRS; ++p) {
        // C = min(P, carry + k), k - k0 = p, p + 8
        unsigned c = vaddmin_s(carry, static_cast<unsigned>(p)
                                      | (static_cast<unsigned>(p + 8) << 16),
                               pc[p]);
        const unsigned l1 = vmin_u(c ^ e[p], ONES);       // left: c < e
        const unsigned u1 = vmin_u(e0[p] ^ dg[p], ONES);  // up < diag
        unsigned mv = vaddmax_u(l1, l1, u1);              // 2 / 1 / 0
        if (KIND != INNER) {
            if (KIND == J0) mv = sel(j0m[p], ONES, mv);
            mv = sel(inv[p], 3 * ONES, mv);
            c = sel(inv[p], INF2, c);
            if (live) cost[p] = c;
        } else {
            cost[p] = c;
        }
        mvs[p] = mv;
    }
    // bytes in cell order: (p, p+1, p+8, p+9) per pair of registers, then
    // cells 0-3, 4-7, 8-11, 12-15
    const unsigned a01 = prmt(mvs[0], mvs[1], 0x6240);
    const unsigned a23 = prmt(mvs[2], mvs[3], 0x6240);
    const unsigned a45 = prmt(mvs[4], mvs[5], 0x6240);
    const unsigned a67 = prmt(mvs[6], mvs[7], 0x6240);
    return make_uint4(prmt(a01, a23, 0x5410), prmt(a45, a67, 0x5410),
                      prmt(a01, a23, 0x7632), prmt(a45, a67, 0x7632));
}

// Takes the window's least finite cost (over its half-warp) off its finite
// costs; an all-INF row stays as it is.
__device__ __forceinline__ void rebase(unsigned (&cost)[N_PAIRS]) {
    unsigned lo = cost[0];
#pragma unroll
    for (int p = 1; p < N_PAIRS; ++p) lo = vmin_u(lo, cost[p]);
    unsigned least = min(lo & 0xffffu, lo >> 16);
#pragma unroll
    for (int s = 1; s < 16; s <<= 1)
        least = min(least, __shfl_xor_sync(FULL, least, s, 16));
    const unsigned off = (least < INF16 ? least : 0u) * ONES;
#pragma unroll
    for (int p = 0; p < N_PAIRS; ++p)
        cost[p] -= off & __vcmpltu2(cost[p], INF2);  // finite halves >= least
}

// One group of GROUP = 8 rows from i0 (the t window's rotation returns to
// 0 after it); stops at mrows.
template <RowKind KIND, int R = 0>
__device__ __forceinline__ void fill_group(
        unsigned (&cost)[N_PAIRS], unsigned (&tw)[N_PAIRS], int i0, int mrows,
        int m, const unsigned (&qc)[GROUP], const unsigned (&tc)[GROUP],
        int l16, int k0, bool real, uint4* out) {
    if constexpr (R < GROUP) {
        const int i = i0 + R;
        if (i > mrows) return;
        const uint4 mv = fill_row<KIND, R>(cost, tw, i, m, qc[R], tc[R], l16, k0);
        if (real) out[static_cast<long long>(i - 1) * (BW / 16)] = mv;
        fill_group<KIND, R + 1>(cost, tw, i0, mrows, m, qc, tc, l16, k0, real, out);
    }
}

__global__ void __launch_bounds__(N_WARPS * 32)
band_fill_kernel(const uint8_t* __restrict__ q, long long q_stride,
                 const uint8_t* __restrict__ t, long long t_stride,
                 const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                 int8_t* __restrict__ moves, int B, int mrows) {
    const int lane = threadIdx.x & 31;
    const int l16 = lane & 15;
    const int warp = blockIdx.x * N_WARPS + (threadIdx.x >> 5);
    if (warp * 2 >= B) return;  // whole warps only: the shuffles stay full
    const int b = warp * 2 + (lane >> 4);
    const bool real = b < B;    // an odd B leaves a half-warp idle
    const int mb = real ? m[b] : 0;
    const int nb = real ? n[b] : 0;
    const uint8_t* qb = q + (real ? b : 0) * q_stride;
    const uint8_t* tb = t + (real ? b : 0) * t_stride;
    uint4* out = reinterpret_cast<uint4*>(
        moves + static_cast<long long>(real ? b : 0) * mrows * BW) + l16;
    const int k0 = l16 * N_PER;

    unsigned cost[N_PAIRS], tw[N_PAIRS];
#pragma unroll
    for (int p = 0; p < N_PAIRS; ++p) {
        unsigned h[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j0 = k0 + p + 8 * u - HB;  // row 0: C[0, j] = j on [0, n]
            h[u] = (j0 >= 0 && j0 <= nb) ? static_cast<unsigned>(j0) : INF16;
        }
        cost[p] = h[0] | (h[1] << 16);
        // the window of row 0: t positions k - 129
        const int pos = k0 + p - HB - 1;
        tw[p] = t_half(tb, nb, pos) | (t_half(tb, nb, pos + 8) << 16);
    }

    // q of row i and the last lane's new t half of row i, a group ahead
    auto q_of = [&](int i) -> unsigned {
        return (i <= mb) ? static_cast<unsigned>(qb[i - 1]) : Q_PAD;
    };
    auto top_of = [&](int i) -> unsigned {
        return l16 == 15 ? t_half(tb, nb, i + HB - 2) : 0u;  // pos i + 126
    };
    // the last row with every cell of both windows inside [1, n] and live:
    // i + 127 <= n and i <= m (rows from HB + 1 on have no j <= 0 cell)
    int inner_last = min(nb - (HB - 1), min(mb, mrows));
    if (!real) inner_last = 0;
    inner_last = min(inner_last, __shfl_xor_sync(FULL, inner_last, 16));

    unsigned qn[GROUP], tn[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
        qn[g] = (1 + g <= mrows) ? q_of(1 + g) : 0u;
        tn[g] = (1 + g <= mrows) ? top_of(1 + g) : 0u;
    }
    for (int i0 = 1; i0 <= mrows; i0 += GROUP) {
        unsigned qc[GROUP], tc[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
            qc[g] = qn[g];
            tc[g] = tn[g];
            const int ii = i0 + GROUP + g;
            qn[g] = (ii <= mrows) ? q_of(ii) : 0u;
            tn[g] = (ii <= mrows) ? top_of(ii) : 0u;
        }
        if (i0 > HB && (i0 - 1) % REBASE == 0) rebase(cost);
        // the row kind is chosen per group: uniform over the warp
        if (i0 <= HB)
            fill_group<J0>(cost, tw, i0, mrows, mb, qc, tc, l16, k0, real, out);
        else if (i0 + GROUP - 1 <= inner_last)
            fill_group<INNER>(cost, tw, i0, mrows, mb, qc, tc, l16, k0, real, out);
        else
            fill_group<EDGE>(cost, tw, i0, mrows, mb, qc, tc, l16, k0, real, out);
    }
}

}  // namespace

extern "C" int hinge_band_fill(const void* q, long long q_stride,
                               const void* t, long long t_stride,
                               const void* m, const void* n, void* moves,
                               int B, int mrows, void* stream) {
    if (B <= 0 || mrows <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* qp = static_cast<const uint8_t*>(q);
    const auto* tp = static_cast<const uint8_t*>(t);
    const auto* mp = static_cast<const int32_t*>(m);
    const auto* np_ = static_cast<const int32_t*>(n);
    auto* out = static_cast<int8_t*>(moves);
    const int per_block = 2 * N_WARPS;
    const int blocks = (B + per_block - 1) / per_block;
    band_fill_kernel<<<blocks, N_WARPS * 32, 0, s>>>(
        qp, q_stride, tp, t_stride, mp, np_, out, B, mrows);
    return static_cast<int>(cudaGetLastError());
}
