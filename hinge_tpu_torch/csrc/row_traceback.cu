// Row-synchronised traceback over banded-NW move codes, for Hopper.
//
// Replaces the Pallas TPU kernel
// hinge_tpu/ops/pallas_band_nw.py::_row_traceback_pallas (body :247,
// pallas_call at :279); the plain torch twin is
// hinge_tpu_torch/ops/band_nw.py::row_traceback_ref.  Outputs are
// bit-identical to both for any int8 move codes.
//
// Every optimal path visits each DP row once, so walking rows
// r = min(m, mrows)-1 .. 0 with the current column j of the window
// resolves a row per step: with k_e = clamp(j - (r+1) + 128, 0, 255),
//   top   = max over lanes k <= k_e with move != 2 of (k*4 | move), or -1
//   kstop = top >> 2 (arithmetic), mv0 = top & 3, cnt = k_e - kstop
//   j    -= cnt + (mv0 == 0)
// cnt is stored as uint8 (256 wraps to 0), rows r >= m store zeros.
//
// What bounds it on this card: the bytes the walk needs are, of each
// active row, the 32-byte sectors that hold lanes 0..k_e (about half the
// row), so the floor is those over HBM bandwidth.  The kernel reads whole
// rows: which sectors a row needs is known only once j is.  And j of
// row r decides what row r-1 needs, so each window is a serial chain of
// ~1k steps, and a kernel that waits for each row's load on that chain is
// bound by the load latency instead.
// What the design does about it: a row's load does not depend on j, only
// its mask does.  So one warp per window (8 cells a lane, one 8-byte word)
// loads the next 16 rows into registers while it resolves the current 16:
// the loads leave the chain.  What stays on it per row is short: the
// lane's non-left cells are a bit mask computed from the word off the
// chain, k_e masks it, the highest set bit (one clz) gives the lane's
// candidate, and one __reduce_max_sync the warp's.  The per-row outputs
// are buffered across the lanes (lane r % 32 keeps row r) and written as
// 32 coalesced bytes every 32 rows.
// The mask form holds for codes 0..3, what band_fill writes: there the
// highest non-left lane wins the max.  A group of rows holding any other
// code takes, in a loop of its own, the twin's max over every cell
// (k*4 + code, -1 where masked).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BW = 256;
constexpr int HB = BW / 2;
constexpr int PER = BW / 32;
constexpr int WARPS = 4;
constexpr int GROUP = 16;  // rows in flight ahead of the chain
constexpr unsigned FULL = 0xffffffffu;

// bit p set where byte p of w (a move code 0..3) is not 2 (left)
__device__ __forceinline__ unsigned nonleft_bits(uint64_t w) {
    const uint64_t x = w ^ 0x0202020202020202ull;
    const uint64_t y = (x | (x >> 1)) & 0x0101010101010101ull;
    // gather the bytes' low bits: b0 + 2 b1 + 4 b2 + 8 b3 lands in byte 3
    const unsigned lo = (static_cast<unsigned>(y) * 0x01020408u) >> 24;
    const unsigned hi = (static_cast<unsigned>(y >> 32) * 0x01020408u) >> 24;
    return (lo & 0xfu) | ((hi & 0xfu) << 4);
}

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
    const int active_rows = mb < 0 ? 0 : (mb < mrows ? mb : mrows);
    for (int r = active_rows + lane; r < mrows; r += 32) {
        cnts[row0 + r] = 0;
        mv0s[row0 + r] = 0;
    }

    int j = n[b];
    const int k0 = lane * PER;
    unsigned my_cnt = 0, my_mv0 = 0;  // row (r & ~31) + lane of this chunk
    uint64_t cur[GROUP];
    int r = active_rows - 1;
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
        cur[g] = (r - g >= 0) ? __ldg(mv + static_cast<long long>(r - g) * (BW / 8)) : 0;
    // k_e of row rr, and how many of this lane's cells lie at or below it
    auto k_e_of = [&](int rr, int& sh) {
        int k_e = j - (rr + 1) + HB;
        k_e = k_e < 0 ? 0 : (k_e > BW - 1 ? BW - 1 : k_e);
        sh = k_e - k0 + 1;
        sh = sh < 0 ? 0 : (sh > PER ? PER : sh);
        return k_e;
    };
    // the warp's max of the lanes' keys resolves row rr
    auto resolve = [&](int rr, int k_e, int best) {
        const int top = __reduce_max_sync(FULL, best);
        const int kstop = top >> 2;
        const int mv0 = top & 3;
        const int cnt = k_e - kstop;
        j -= cnt + (mv0 == 0 ? 1 : 0);
        if (lane == (rr & 31)) {
            my_cnt = static_cast<unsigned>(cnt) & 0xffu;
            my_mv0 = static_cast<unsigned>(mv0);
        }
        if ((rr & 31) == 0) {  // the chunk rr .. rr + 31 is done
            if (rr + lane < mrows) {
                cnts[row0 + rr + lane] = static_cast<uint8_t>(my_cnt);
                mv0s[row0 + rr + lane] = static_cast<int8_t>(my_mv0);
            }
            my_cnt = my_mv0 = 0;
        }
    };
    while (r >= 0) {
        uint64_t nxt[GROUP], any = 0;
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
            const int rr = r - GROUP - g;
            nxt[g] = rr >= 0 ? __ldg(mv + static_cast<long long>(rr) * (BW / 8)) : 0;
            any |= cur[g];
        }
        if (__any_sync(FULL, (any & 0xFCFCFCFCFCFCFCFCull) != 0)) {
            // a code outside 0..3: every cell's key, rows read again
#pragma unroll 1
            for (int rr = r; rr > r - GROUP && rr >= 0; --rr) {
                const uint64_t w = __ldg(mv + static_cast<long long>(rr) * (BW / 8));
                int sh;
                const int k_e = k_e_of(rr, sh);
                int best = INT_MIN;
#pragma unroll
                for (int p = 0; p < PER; ++p) {
                    const int c = static_cast<int8_t>(w >> (8 * p));
                    best = max(best, (p < sh && c != 2) ? (k0 + p) * 4 + c : -1);
                }
                resolve(rr, k_e, best);
            }
        } else {
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const int rr = r - g;
                if (rr < 0) break;
                const uint64_t w = cur[g];
                int sh;
                const int k_e = k_e_of(rr, sh);
                const unsigned mm = nonleft_bits(w) & ((1u << sh) - 1u);
                int best = -1;
                if (mm) {
                    const int p = 31 - __clz(mm);
                    best = (k0 + p) * 4 + static_cast<int>((w >> (8 * p)) & 3u);
                }
                resolve(rr, k_e, best);
            }
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) cur[g] = nxt[g];
        r -= GROUP;
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
