// Banded Needleman-Wunsch fill (unit costs, band width 256) for Hopper.
//
// Replaces the Pallas TPU kernel hinge_tpu/ops/pallas_band_nw.py::_band_fill
// (body `kernel`, pallas_call at :166); the plain torch twin is
// hinge_tpu_torch/ops/band_nw.py::band_fill_ref.  The move codes it writes
// are bit-identical to both.
//
// Recurrence, band coordinate k = j - i + 128, one DP row i per step:
//   diag  (i-1, j-1) -> same lane k          (cost row kept in registers)
//   up    (i-1, j)   -> lane k+1             (one __shfl_down_sync)
//   left  (i, j-1)   -> in-row prefix-min:   C = min(E, k + cummin(E - k))
//   sub   q[i-1] vs t[j-1]
// Lane j == 0 gets cost i and move up; lanes with j outside [1, n] get INF
// and move 3; rows i > m keep the row-m cost row (frozen), their moves are
// still written.  Ties: 2 if C < E, else 0 if diag <= up, else 1.
//
// What bounds it on this card: a serial chain of ~1k dependent rows per
// window; each row is ~150 integer ops per lane plus 5 shuffle rounds of
// latency.  The 256-byte move row per step is the only HBM traffic
// (2048 windows x 1024 rows = 512 MiB per block, ~0.15 ms at 3.35 TB/s),
// so the kernel is latency-bound, not bandwidth-bound.
// What the design does about it: one warp per window with 8 band cells
// per lane, so the cost row lives in registers and a row costs one
// shuffle for "up" plus a 5-step __shfl_up_sync scan for the prefix-min
// (serial over each lane's 8 cells first); no shared memory and no block
// barriers, and each lane stores its 8 moves as one 8-byte word so a
// warp writes its 256-byte row coalesced.  The 250/251/252 pads of the
// TPU layout are never materialised: t and q bytes are read only where
// the lane is inside [1, n] and the row inside [1, m], which gives the
// same comparisons as the padded layout.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BW = 256;
constexpr int HB = BW / 2;
constexpr int PER = BW / 32;  // band cells per lane
constexpr int INF = 1 << 24;
constexpr int WARPS = 4;      // windows per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
band_fill_kernel(const uint8_t* __restrict__ q, long long q_stride,
                 const uint8_t* __restrict__ t, long long t_stride,
                 const int32_t* __restrict__ m, const int32_t* __restrict__ n,
                 int8_t* __restrict__ moves, int B, int mrows) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // whole warps only: the shuffles below stay full
    const int mb = m[b];
    const int nb = n[b];
    const uint8_t* qb = q + b * q_stride;
    const uint8_t* tb = t + b * t_stride;
    uint64_t* out = reinterpret_cast<uint64_t*>(
        moves + static_cast<long long>(b) * mrows * BW) + lane;
    const int k0 = lane * PER;

    int cost[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
        const int j0 = k0 + p - HB;  // row 0: C[0, j] = j on [0, n]
        cost[p] = (j0 >= 0 && j0 <= nb) ? j0 : INF;
    }

    for (int i = 1; i <= mrows; ++i) {
        int up_next = __shfl_down_sync(FULL, cost[0], 1);
        if (lane == 31) up_next = INF;
        const int qc = (i <= mb) ? static_cast<int>(qb[i - 1]) : -1;

        int e[PER], dg[PER], upc[PER];
        bool keep[PER];
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            const int j = i + k0 + p - HB;
            const bool valid = j >= 1 && j <= nb;
            const int up = (p < PER - 1) ? cost[p + 1] : up_next;
            const int sub = (valid && qc == static_cast<int>(tb[j - 1])) ? 0 : 1;
            dg[p] = cost[p] + sub;
            upc[p] = up + 1;
            int ee = valid ? min(dg[p], upc[p]) : INF;
            if (j == 0) ee = i;
            e[p] = ee;
            keep[p] = valid || j == 0;
        }

        // inclusive prefix-min of e[k] - k over the 256 band cells:
        // serial over this lane's cells, then a warp scan of lane totals
        int g[PER];
        g[0] = e[0] - k0;
#pragma unroll
        for (int p = 1; p < PER; ++p) g[p] = min(g[p - 1], e[p] - (k0 + p));
        int run = g[PER - 1];
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int o = __shfl_up_sync(FULL, run, s);
            if (lane >= s) run = min(run, o);
        }
        int before = __shfl_up_sync(FULL, run, 1);
        if (lane == 0) before = INT_MAX;

        uint64_t packed = 0;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            const int k = k0 + p;
            // the TPU kernel's shifted-in INF caps the scan at INF
            const int gg = min(min(g[p], before), INF);
            int c = min(e[p], gg + k);
            int mv;
            if (!keep[p]) {
                c = INF;
                mv = 3;
            } else if (i + k - HB == 0) {
                mv = 1;
            } else {
                mv = (c < e[p]) ? 2 : (dg[p] <= upc[p] ? 0 : 1);
            }
            packed |= static_cast<uint64_t>(mv) << (8 * p);
            if (i <= mb) cost[p] = c;
        }
        out[static_cast<long long>(i - 1) * (BW / 8)] = packed;
    }
}

}  // namespace

extern "C" int hinge_band_fill(const void* q, long long q_stride,
                               const void* t, long long t_stride,
                               const void* m, const void* n, void* moves,
                               int B, int mrows, void* stream) {
    if (B <= 0 || mrows <= 0) return 0;
    const int blocks = (B + WARPS - 1) / WARPS;
    band_fill_kernel<<<blocks, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(q), q_stride,
        static_cast<const uint8_t*>(t), t_stride,
        static_cast<const int32_t*>(m), static_cast<const int32_t*>(n),
        static_cast<int8_t*>(moves), B, mrows);
    return static_cast<int>(cudaGetLastError());
}
