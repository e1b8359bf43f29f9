// DW_banded O(ND) wavefront aligner (forward wave + backtrack), for Hopper.
//
// Replaces the XLA programs hinge_tpu/ops/wavefront.py::_wave_forward
// (:75) and ::_wave_backtrack (:179); the plain torch twin is
// hinge_tpu_torch/ops/wavefront.py::wave_forward_ref + wave_backtrack_ref.
// Outputs (px/py at [0, 2*d_fin+2), aligned, d_fin, k_fin, x_fin) are
// bit-identical to the twin's; the history Vh/minkh/maxkh is scratch of
// which only rows d <= d_fin are written.
//
// Per window and step d (the twin's body, line for line):
//   live only while d < dmax = (int)(0.3f * (m + n)) and the band
//   max_k - min_k <= 2 * band_tolerance (else abort, unaligned);
//   lane l holds diagonal k = min_k + 2l while 2l <= max_k - min_k;
//   x0 = V[k+1] when k == min_k || (k != max_k && V[k-1] < V[k+1]),
//   else V[k-1] + 1; the snake runs from (x0, x0 - k) in chunks of 16
//   compares from a base clipped into [0, L-1], as the twin's;
//   the first lane in ascending order with x >= m or y >= n ends the
//   window; otherwise the band shrinks to the lanes with
//   x + y >= best_m - band_tolerance, widened by one on each side.
//
// What bounds it on this card: almost nothing the wave does is bytes or
// operations.  A window of ~900 bp finishes in ~40 steps of ~50 live
// diagonals, and each step waits on the previous one, so a window is a
// serial chain of short steps; the snake, a data-dependent loop of
// byte compares, is the longest link.  The floor (q/t read once, the
// history rows and path points written once, ~30 integer operations per
// live diagonal and ~6 per snake compare) is far below what the chains'
// latency allows.
// What the design does about it: one warp per window, so a window's
// chain never leaves its warp.  The lanes take the band's diagonals
// (kb <= 32 * KPT, 5 a lane at band_tolerance 150), the previous row V
// (2*max_d+2 int32) and the window's q and t sit in shared memory, the
// snake is a serial compare per diagonal, and the first finishing lane,
// best_m and the new band edges come from warp reductions.  Reads and
// writes of V within a step touch opposite parities of k + max_d, so V
// is updated in place.  The backtrack walks the history serially on
// lane 0 (~d_fin dependent steps).  Many windows per SM (several warps
// per block, several blocks per SM) hide the chains' latency.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;
constexpr int SNAKE = 16;
constexpr int BIG = 1 << 30;
constexpr unsigned NONE = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;

__host__ __device__ __forceinline__ size_t align16(size_t v) {
    return (v + 15) & ~size_t(15);
}

__host__ __device__ __forceinline__ size_t warp_smem(int max_d, int L) {
    return align16(size_t(2 * max_d + 2) * 4) + 2 * align16(size_t(L));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// match run from (x0, y0): chunks of SNAKE compares from a clipped base,
// stopping at the first mismatch (the pads 4 and 5 never match)
__device__ __forceinline__ int snake(const uint8_t* qs, const uint8_t* ts,
                                     int L, int x0, int y0) {
    int run = 0;
    for (;;) {
        const int bx = clampi(x0 + run, 0, L - 1);
        const int by = clampi(y0 + run, 0, L - 1);
        int c = 0;
        for (; c < SNAKE; ++c) {
            if (qs[min(bx + c, L - 1)] != ts[min(by + c, L - 1)]) break;
        }
        run += c;
        if (c < SNAKE) return run;
    }
}

template <int KPT>
__global__ void __launch_bounds__(WARPS * 32)
wave_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  int L, const int32_t* __restrict__ m_,
                  const int32_t* __restrict__ n_, int B, int bt, int max_d,
                  int kb, int16_t* __restrict__ Vh, int16_t* __restrict__ minkh,
                  int16_t* __restrict__ maxkh, int32_t* __restrict__ px,
                  int32_t* __restrict__ py, uint8_t* __restrict__ aligned_o,
                  int32_t* __restrict__ d_fin_o, int32_t* __restrict__ k_fin_o,
                  int32_t* __restrict__ x_fin_o) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const int w = blockIdx.x * WARPS + wib;
    if (w >= B) return;  // whole warps leave; no block-wide barrier follows

    const int KW = 2 * max_d + 2;
    unsigned char* base = smem + size_t(wib) * warp_smem(max_d, L);
    int32_t* V = reinterpret_cast<int32_t*>(base);
    uint8_t* qs = base + align16(size_t(KW) * 4);
    uint8_t* ts = qs + align16(size_t(L));
    const uint8_t* qg = q + size_t(w) * L;
    const uint8_t* tg = t + size_t(w) * L;
    for (int i = lane; i < KW; i += 32) V[i] = 0;
    for (int i = lane; i < L; i += 32) {
        qs[i] = qg[i];
        ts[i] = tg[i];
    }
    __syncwarp();

    const int m = m_[w], n = n_[w];
    const int dmax = static_cast<int>(0.3f * static_cast<float>(m + n));
    const int band_size = 2 * bt;
    const int K0 = max_d;
    int16_t* vh = Vh + size_t(w) * max_d * kb;
    int16_t* mkh = minkh + size_t(w) * max_d;
    int16_t* xkh = maxkh + size_t(w) * max_d;
    int best_m = -1, min_k = 0, max_k = 0;
    bool aligned = false;
    int d_fin = 0, k_fin = 0, x_fin = 0;

    for (int d = 0; d < max_d && d < dmax; ++d) {
        if (max_k - min_k > band_size) break;  // band overflow: unaligned
        int xs[KPT];
        bool ok[KPT];
        // read phase: every lane's x from the previous row of V
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
            const int bl = j * 32 + lane;
            const int k = min_k + 2 * bl;
            ok[j] = bl < kb && 2 * bl <= max_k - min_k;
            int x = 0;
            if (ok[j]) {
                const int g = clampi(k + K0, 1, KW - 2);
                const int vm1 = V[g - 1], vp1 = V[g + 1];
                const bool right = k == min_k || (k != max_k && vm1 < vp1);
                const int x0 = right ? vp1 : vm1 + 1;
                const int y0 = x0 - k;
                x = x0 + ((x0 < m && y0 < n) ? snake(qs, ts, L, x0, y0) : 0);
            }
            xs[j] = x;
        }
        __syncwarp();
        // write phase: history row d, V in place, first finishing lane
        unsigned fin = NONE;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
            const int bl = j * 32 + lane;
            if (bl < kb) vh[size_t(d) * kb + bl] = static_cast<int16_t>(ok[j] ? xs[j] : 0);
            if (ok[j]) {
                const int k = min_k + 2 * bl;
                const int idx = k + K0;
                if (idx >= 0 && idx < KW) V[idx] = xs[j];
                if (fin == NONE && (xs[j] >= m || xs[j] - k >= n))
                    fin = static_cast<unsigned>(bl);
            }
        }
        if (lane == 0) {
            mkh[d] = static_cast<int16_t>(min_k);
            xkh[d] = static_cast<int16_t>(max_k);
        }
        const unsigned flane = __reduce_min_sync(FULL, fin);
        if (flane != NONE) {
            int xv = 0;
#pragma unroll
            for (int j = 0; j < KPT; ++j)
                if (j == static_cast<int>(flane >> 5)) xv = xs[j];
            xv = __shfl_sync(FULL, xv, flane & 31);
            aligned = true;
            d_fin = d;
            k_fin = min_k + 2 * static_cast<int>(flane);
            x_fin = xv;
            break;
        }
        // band update (DW_banded.c:188-201)
        int mu = -BIG;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
            const int k = min_k + 2 * (j * 32 + lane);
            if (ok[j]) mu = max(mu, 2 * xs[j] - k);
        }
        const int best_m2 = max(best_m, __reduce_max_sync(FULL, mu));
        int kmin = BIG, kmax = -BIG;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
            const int k = min_k + 2 * (j * 32 + lane);
            if (ok[j] && 2 * xs[j] - k >= best_m2 - bt) {
                kmin = min(kmin, k);
                kmax = max(kmax, k);
            }
        }
        kmin = __reduce_min_sync(FULL, kmin);
        kmax = __reduce_max_sync(FULL, kmax);
        const bool keep = kmin != BIG;
        const int new_min = keep ? kmin : max_k;
        const int new_max = keep ? kmax : min_k;
        min_k = new_min - 1;
        max_k = new_max + 1;
        best_m = best_m2;
        __syncwarp();
    }
    __syncwarp();  // the history rows of every lane, before lane 0 walks them

    if (lane != 0) return;
    const int W = KW;
    int32_t* pxw = px + size_t(w) * W;
    int32_t* pyw = py + size_t(w) * W;
    aligned_o[w] = aligned ? 1 : 0;
    d_fin_o[w] = d_fin;
    k_fin_o[w] = k_fin;
    x_fin_o[w] = x_fin;
    if (!aligned) {
        pxw[0] = pxw[1] = pyw[0] = pyw[1] = 0;
        return;
    }
    int k = k_fin, x2 = x_fin;
    for (int d = d_fin; d >= 0; --d) {
        const int dm1 = max(d - 1, 0);
        const int mk1 = mkh[dm1];
        // floor division by 2 (arithmetic shift), as the twin's
        const int lm = clampi((k - 1 - mk1) >> 1, 0, kb - 1);
        const int lp = clampi((k + 1 - mk1) >> 1, 0, kb - 1);
        const int vm1 = vh[size_t(dm1) * kb + lm];
        const int vp1 = vh[size_t(dm1) * kb + lp];
        const int mk = mkh[d], xk = xkh[d];
        const bool right = k == mk || (k != xk && vm1 < vp1);
        const int x1 = d == 0 ? 0 : (right ? vp1 : vm1 + 1);
        const int pos = clampi(2 * d, 0, W - 2);
        pxw[pos] = x1;
        pyw[pos] = x1 - k;
        pxw[pos + 1] = x2;
        pyw[pos + 1] = x2 - k;
        if (d > 0) {
            k = right ? k + 1 : k - 1;
            x2 = right ? vp1 : vm1;
        }
    }
}

template <int KPT>
int launch(const uint8_t* q, const uint8_t* t, int L, const int32_t* m,
           const int32_t* n, int B, int bt, int max_d, int kb, int16_t* Vh,
           int16_t* minkh, int16_t* maxkh, int32_t* px, int32_t* py,
           uint8_t* aligned, int32_t* d_fin, int32_t* k_fin, int32_t* x_fin,
           cudaStream_t stream) {
    const size_t smem = WARPS * warp_smem(max_d, L);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            wave_align_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (B + WARPS - 1) / WARPS;
    wave_align_kernel<KPT><<<blocks, WARPS * 32, smem, stream>>>(
        q, t, L, m, n, B, bt, max_d, kb, Vh, minkh, maxkh, px, py, aligned,
        d_fin, k_fin, x_fin);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (ops/wavefront.py::launch_wave_align) checks kb and the
// shared memory (WARPS * warp_smem) before it calls this.
extern "C" int hinge_wave_align(const void* q, const void* t, long long L,
                                const void* m, const void* n, int B, int bt,
                                int max_d, int kb, void* Vh, void* minkh,
                                void* maxkh, void* px, void* py, void* aligned,
                                void* d_fin, void* k_fin, void* x_fin,
                                void* stream) {
    if (B <= 0) return 0;
    if (kb < 1 || kb > 256 || max_d < 1 || L < 1 || L > INT_MAX ||
        WARPS * warp_smem(max_d, static_cast<int>(L)) > SMEM_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int kpt = (kb + 31) / 32;
#define HINGE_WAVE_CASE(K)                                                   \
    case K:                                                                  \
        return launch<K>(static_cast<const uint8_t*>(q),                     \
                         static_cast<const uint8_t*>(t), static_cast<int>(L), \
                         static_cast<const int32_t*>(m),                     \
                         static_cast<const int32_t*>(n), B, bt, max_d, kb,   \
                         static_cast<int16_t*>(Vh), static_cast<int16_t*>(minkh), \
                         static_cast<int16_t*>(maxkh), static_cast<int32_t*>(px), \
                         static_cast<int32_t*>(py), static_cast<uint8_t*>(aligned), \
                         static_cast<int32_t*>(d_fin), static_cast<int32_t*>(k_fin), \
                         static_cast<int32_t*>(x_fin),                       \
                         static_cast<cudaStream_t>(stream));
    switch (kpt) {
        HINGE_WAVE_CASE(1)
        HINGE_WAVE_CASE(2)
        HINGE_WAVE_CASE(3)
        HINGE_WAVE_CASE(4)
        HINGE_WAVE_CASE(5)
        HINGE_WAVE_CASE(6)
        HINGE_WAVE_CASE(7)
        HINGE_WAVE_CASE(8)
    }
#undef HINGE_WAVE_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
