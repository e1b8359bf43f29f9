// Row-synchronised traceback over banded-NW move codes, for Hopper.
//
// Replaces the Pallas TPU kernel
// hinge_tpu/ops/pallas_band_nw.py::_row_traceback_pallas (body :247,
// pallas_call at :279); the plain torch twin is
// hinge_tpu_torch/ops/band_nw.py::row_traceback_ref.  Outputs are
// bit-identical to both.
//
// Every optimal path visits each DP row once, so walking rows
// r = min(m, mrows)-1 .. 0 with the current column j of the window
// resolves a row per step: with k_e = clamp(j - (r+1) + 128, 0, 255),
//   top   = max over lanes k <= k_e with move != 2 of (k*4 | move), or -1
//   kstop = top >> 2 (arithmetic), mv0 = top & 3, cnt = k_e - kstop
//   j    -= cnt + (mv0 == 0)
// cnt is stored as uint8 (256 wraps to 0), rows r >= m store zeros.
//
// What bounds it on this card: one dependent 256-byte row read per step
// (j of row r decides what row r-1 needs), so it is bound by the load
// latency of ~1k serial steps per window, not by bandwidth (512 MiB of
// moves per 2048-window block, read once).
// What the design does about it: one warp per window; each lane reads
// 8 move bytes of the row as one 8-byte word (a coalesced 256-byte warp
// load), reduces its cells in registers and the warp combines them with
// one __reduce_max_sync.  j stays in a register; the moves stay in
// HBM/L2 (a 1k-row window holds 256 KB of moves, more than shared
// memory).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BW = 256;
constexpr int HB = BW / 2;
constexpr int PER = BW / 32;
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
row_traceback_kernel(const int8_t* __restrict__ moves,
                     const int32_t* __restrict__ m,
                     const int32_t* __restrict__ n,
                     uint8_t* __restrict__ cnts, int8_t* __restrict__ mv0s,
                     int32_t* __restrict__ j_rem, int B, int mrows) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // whole warps only: the reductions stay full
    const long long row0 = static_cast<long long>(b) * mrows;
    const uint64_t* mv = reinterpret_cast<const uint64_t*>(moves + row0 * BW) + lane;
    const int mb = m[b];
    const int active_rows = mb < mrows ? mb : mrows;
    for (int r = (active_rows > 0 ? active_rows : 0) + lane; r < mrows; r += 32) {
        cnts[row0 + r] = 0;
        mv0s[row0 + r] = 0;
    }

    int j = n[b];
    const int k0 = lane * PER;
    for (int r = active_rows - 1; r >= 0; --r) {
        const uint64_t w = __ldg(mv + static_cast<long long>(r) * (BW / 8));
        int k_e = j - (r + 1) + HB;
        k_e = k_e < 0 ? 0 : (k_e > BW - 1 ? BW - 1 : k_e);
        int best = -1;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            const int code = static_cast<int8_t>((w >> (8 * p)) & 0xff);
            const int k = k0 + p;
            if (k <= k_e && code != 2) best = max(best, k * 4 + code);
        }
        const int top = __reduce_max_sync(FULL, best);
        const int kstop = top >> 2;
        const int mv0 = top & 3;
        const int cnt = k_e - kstop;
        j -= cnt + (mv0 == 0 ? 1 : 0);
        if (lane == 0) {
            cnts[row0 + r] = static_cast<uint8_t>(cnt & 0xff);
            mv0s[row0 + r] = static_cast<int8_t>(mv0);
        }
    }
    if (lane == 0) j_rem[b] = j;
}

}  // namespace

extern "C" int hinge_row_traceback(const void* moves, const void* m,
                                   const void* n, void* cnts, void* mv0s,
                                   void* j_rem, int B, int mrows,
                                   void* stream) {
    if (B <= 0) return 0;
    const int blocks = (B + WARPS - 1) / WARPS;
    row_traceback_kernel<<<blocks, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(moves), static_cast<const int32_t*>(m),
        static_cast<const int32_t*>(n), static_cast<uint8_t*>(cnts),
        static_cast<int8_t*>(mv0s), static_cast<int32_t*>(j_rem), B, mrows);
    return static_cast<int>(cudaGetLastError());
}
