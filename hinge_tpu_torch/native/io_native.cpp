// Copied from hinge_tpu/native/io_native.cpp, unchanged.
//
// Native IO core: fast DALIGNER .las scanning/parsing and FASTA indexing.
//
// The reference's data-access layer is C (vendored DB.c/align.c + the
// LAInterface facade, src/lib/LAInterface.cpp).  This library is its
// TPU-framework equivalent: it parses overlap records into the columnar
// struct-of-arrays layout the JAX kernels consume (one contiguous int32
// column per field + a flat uint16 trace array), so Python only wraps
// pointers.  Exposed through a plain C ABI for ctypes.
//
// Record layout per .las spec (align.c:3040-3063): 40-byte frame
// [tlen diffs abpos bbpos aepos bepos flags aread bread pad] followed by
// tlen trace values of uint8 (tspace <= 125) or uint16.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <thread>
#include <cstdint>
#include <cstdio>
#include <chrono>
#include <cstring>
#include <vector>

namespace {

constexpr int kRecBytes = 40;
constexpr int kTraceXovr = 125;

struct Frame {
  int32_t tlen, diffs, abpos, bbpos, aepos, bepos;
  uint32_t flags;
  int32_t aread, bread, pad;
};
static_assert(sizeof(Frame) == kRecBytes, "frame layout");

struct FileBuf {
  std::vector<char> data;
  bool ok = false;
};

FileBuf slurp(const char* path) {
  FileBuf fb;
  FILE* f = std::fopen(path, "rb");
  if (!f) return fb;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  fb.data.resize(static_cast<size_t>(n));
  if (n > 0 && std::fread(fb.data.data(), 1, static_cast<size_t>(n), f) !=
                   static_cast<size_t>(n)) {
    std::fclose(f);
    return fb;
  }
  std::fclose(f);
  fb.ok = true;
  return fb;
}

}  // namespace

extern "C" {

// Pass 1: sizes. Returns 0 on success, negative error codes otherwise.
//   -1 open/read failure, -2 truncated, -3 trailing bytes
int las_scan(const char* path, int64_t* novl, int32_t* tspace,
             int64_t* total_trace_vals) {
  FileBuf fb = slurp(path);
  if (!fb.ok || fb.data.size() < 12) return -1;
  const char* p = fb.data.data();
  int64_t n;
  std::memcpy(&n, p, 8);
  int32_t tsp;
  std::memcpy(&tsp, p + 8, 4);
  const int tbytes = (tsp <= kTraceXovr) ? 1 : 2;
  size_t pos = 12;
  int64_t tot = 0;
  for (int64_t k = 0; k < n; k++) {
    if (pos + kRecBytes > fb.data.size()) return -2;
    int32_t tlen;
    std::memcpy(&tlen, p + pos, 4);
    if (tlen < 0) return -2;
    tot += tlen;
    pos += kRecBytes + static_cast<size_t>(tbytes) * tlen;
  }
  if (pos > fb.data.size()) return -2;
  if (pos != fb.data.size()) return -3;
  *novl = n;
  *tspace = tsp;
  *total_trace_vals = tot;
  return 0;
}

// Pass 2: fill caller-allocated columns. b coords are flipped to B's
// forward strand for reverse-complement records (LAInterface.cpp:1606-1626)
// when b_len (per-read lengths indexed by bread) is non-null.
int las_parse(const char* path, const int32_t* read_len, int64_t n_reads,
              int32_t* a_id, int32_t* b_id, int32_t* a_len, int32_t* b_len,
              int32_t* a_start, int32_t* a_end, int32_t* b_start,
              int32_t* b_end, int32_t* rc, int32_t* diffs, int32_t* tlen_out,
              int64_t* trace_off, uint16_t* trace) {
  FileBuf fb = slurp(path);
  if (!fb.ok || fb.data.size() < 12) return -1;
  const char* p = fb.data.data();
  int64_t n;
  std::memcpy(&n, p, 8);
  int32_t tsp;
  std::memcpy(&tsp, p + 8, 4);
  const int tbytes = (tsp <= kTraceXovr) ? 1 : 2;
  size_t pos = 12;
  int64_t toff = 0;
  for (int64_t k = 0; k < n; k++) {
    if (pos + kRecBytes > fb.data.size()) return -2;
    Frame fr;
    std::memcpy(&fr, p + pos, kRecBytes);
    pos += kRecBytes;
    const int32_t rcv = static_cast<int32_t>(fr.flags & 0x1u);
    a_id[k] = fr.aread;
    b_id[k] = fr.bread;
    const int32_t al =
        (read_len && fr.aread < n_reads) ? read_len[fr.aread] : 0;
    const int32_t bl =
        (read_len && fr.bread < n_reads) ? read_len[fr.bread] : 0;
    a_len[k] = al;
    b_len[k] = bl;
    a_start[k] = fr.abpos;
    a_end[k] = fr.aepos;
    if (rcv) {
      b_start[k] = bl - fr.bepos;
      b_end[k] = bl - fr.bbpos;
    } else {
      b_start[k] = fr.bbpos;
      b_end[k] = fr.bepos;
    }
    rc[k] = rcv;
    diffs[k] = fr.diffs;
    tlen_out[k] = fr.tlen;
    trace_off[k] = toff;
    if (pos + static_cast<size_t>(tbytes) * fr.tlen > fb.data.size())
      return -2;
    if (tbytes == 1) {
      const uint8_t* t8 = reinterpret_cast<const uint8_t*>(p + pos);
      for (int32_t j = 0; j < fr.tlen; j++) trace[toff + j] = t8[j];
    } else {
      std::memcpy(trace + toff, p + pos, 2 * static_cast<size_t>(fr.tlen));
    }
    toff += fr.tlen;
    pos += static_cast<size_t>(tbytes) * fr.tlen;
  }
  return 0;
}

// 2-bit base packing/unpacking (DAZZ_DB Compress_Read convention:
// first base in the high bits, DB.c:288-308).
void pack_bases(const uint8_t* codes, int64_t n, uint8_t* out) {
  int64_t nby = (n + 3) / 4;
  for (int64_t i = 0; i < nby; i++) {
    uint8_t b = 0;
    for (int j = 0; j < 4; j++) {
      int64_t idx = 4 * i + j;
      uint8_t c = (idx < n) ? codes[idx] : 0;
      b = static_cast<uint8_t>((b << 2) | (c & 3));
    }
    out[i] = b;
  }
}

void unpack_bases(const uint8_t* packed, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = (packed[i / 4] >> (6 - 2 * (i % 4))) & 3;
  }
}

// FASTA scan: record offsets + lengths so Python can build the store
// without per-line work. Returns number of sequences, or -1.
int64_t fasta_scan(const char* path, int64_t max_records, int64_t* seq_len,
                   int64_t* name_off, int64_t* name_len) {
  FileBuf fb = slurp(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const size_t n = fb.data.size();
  int64_t cnt = -1;
  size_t i = 0;
  while (i < n) {
    if (p[i] == '>') {
      cnt++;
      if (cnt >= max_records) return -2;
      size_t j = i + 1;
      while (j < n && p[j] != '\n' && p[j] != ' ' && p[j] != '\t') j++;
      name_off[cnt] = static_cast<int64_t>(i + 1);
      name_len[cnt] = static_cast<int64_t>(j - (i + 1));
      seq_len[cnt] = 0;
      while (j < n && p[j] != '\n') j++;
      i = j + 1;
    } else {
      size_t j = i;
      while (j < n && p[j] != '\n') j++;
      if (cnt >= 0) seq_len[cnt] += static_cast<int64_t>(j - i);
      i = j + 1;
    }
  }
  return cnt + 1;
}

}  // extern "C"

// ---- minimizer extraction (hinge_tpu.overlap.mapper's rolling hash) ----
// Must match the numpy implementation bit-for-bit: k-base 2-bit pack with
// uint64 wraparound, then the splitmix-style finalizer.

extern "C" {

static inline uint64_t mix64(uint64_t v) {
  v = (v ^ (v >> 30)) * 0xBF58476D1CE4E5B9ULL;
  v = (v ^ (v >> 27)) * 0x94D049BB133111EBULL;
  return v ^ (v >> 31);
}

// Returns the number of minimizers written (positions ascending, unique).
int64_t minimizers(const uint8_t* codes, int64_t n, int32_t k, int32_t w,
                   int64_t* out_pos, uint64_t* out_hash) {
  if (n < k) return 0;
  const int64_t m = n - k + 1;
  std::vector<uint64_t> h(static_cast<size_t>(m));
  uint64_t v = 0;
  for (int64_t i = 0; i < k; i++) v = (v << 2) | (codes[i] & 3);
  h[0] = mix64(v);
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  for (int64_t i = 1; i < m; i++) {
    v = ((v << 2) | (codes[i + k - 1] & 3)) & mask;
    h[i] = mix64(v);
  }
  int64_t cnt = 0;
  if (m <= w) {
    int64_t p = 0;
    for (int64_t i = 1; i < m; i++)
      if (h[i] < h[p]) p = i;
    out_pos[0] = p;
    out_hash[0] = h[p];
    return 1;
  }
  // monotonic deque over windows of width w; emit argmin per window,
  // deduplicated (numpy path: np.unique of per-window argmin indices)
  std::vector<int64_t> dq(static_cast<size_t>(m));
  int64_t head = 0, tail = 0;  // [head, tail)
  int64_t last_emit = -1;
  for (int64_t i = 0; i < m; i++) {
    while (tail > head && h[dq[tail - 1]] > h[i]) tail--;
    // numpy argmin keeps the FIRST minimum; preserve ties accordingly:
    // only pop strictly larger values (above), so earlier equal stays.
    dq[tail++] = i;
    if (dq[head] <= i - w) head++;
    if (i >= w - 1) {
      int64_t p = dq[head];
      if (p != last_emit) {
        out_pos[cnt] = p;
        out_hash[cnt] = h[p];
        cnt++;
        last_emit = p;
      }
    }
  }
  return cnt;
}

// Core shared by `minimizers` and `minimizers_batch`: int32 positions,
// caller-provided scratch so batch calls do not re-allocate per sequence.
static int64_t mini_core(const uint8_t* codes, int64_t n, int32_t k,
                         int32_t w, int32_t* out_pos, uint64_t* out_hash,
                         std::vector<uint64_t>& h, std::vector<int64_t>& dq) {
  if (n < k) return 0;
  const int64_t m = n - k + 1;
  if (static_cast<int64_t>(h.size()) < m) {
    h.resize(static_cast<size_t>(m));
    dq.resize(static_cast<size_t>(m));
  }
  uint64_t v = 0;
  for (int64_t i = 0; i < k; i++) v = (v << 2) | (codes[i] & 3);
  h[0] = mix64(v);
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  for (int64_t i = 1; i < m; i++) {
    v = ((v << 2) | (codes[i + k - 1] & 3)) & mask;
    h[static_cast<size_t>(i)] = mix64(v);
  }
  int64_t cnt = 0;
  if (m <= w) {
    int64_t p = 0;
    for (int64_t i = 1; i < m; i++)
      if (h[static_cast<size_t>(i)] < h[static_cast<size_t>(p)]) p = i;
    out_pos[0] = static_cast<int32_t>(p);
    out_hash[0] = h[static_cast<size_t>(p)];
    return 1;
  }
  int64_t head = 0, tail = 0;
  int64_t last_emit = -1;
  for (int64_t i = 0; i < m; i++) {
    while (tail > head && h[static_cast<size_t>(dq[tail - 1])] > h[static_cast<size_t>(i)]) tail--;
    dq[static_cast<size_t>(tail++)] = i;
    if (dq[static_cast<size_t>(head)] <= i - w) head++;
    if (i >= w - 1) {
      int64_t p = dq[static_cast<size_t>(head)];
      if (p != last_emit) {
        out_pos[cnt] = static_cast<int32_t>(p);
        out_hash[cnt] = h[static_cast<size_t>(p)];
        cnt++;
        last_emit = p;
      }
    }
  }
  return cnt;
}

// Batched minimizer extraction, threaded over sequences.  Streams are
// written at caller-computed worst-case offsets `cap_off` (n_streams+1;
// stream i capacity = max(len_i - k + 1, 0)), then compacted to be
// contiguous; per-stream counts land in out_cnt.  both_strands=1 emits
// 2 streams per sequence (forward, then reverse complement — matching
// mapper._map_block's query stream layout).  Returns total minimizers.
int64_t minimizers_batch(const uint8_t* codes, const int64_t* seq_off,
                         int64_t n_seq, int32_t k, int32_t w,
                         int32_t both_strands, const int64_t* cap_off,
                         int32_t* out_pos, uint64_t* out_hash,
                         int64_t* out_cnt) {
  const int strands = both_strands ? 2 : 1;
  const int64_t n_streams = n_seq * strands;
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? (hw > 8 ? 8 : hw) : 1);
  if (n_seq < 64) n_threads = 1;
  std::atomic<int64_t> next{0};
  const int64_t chunk = 64;

  auto work = [&]() {
    std::vector<uint64_t> h;
    std::vector<int64_t> dq;
    std::vector<uint8_t> rcbuf;
    for (;;) {
      const int64_t c = next.fetch_add(1);
      const int64_t s0 = c * chunk;
      if (s0 >= n_seq) break;
      const int64_t s1 = std::min(n_seq, s0 + chunk);
      for (int64_t s = s0; s < s1; s++) {
        const uint8_t* seq = codes + seq_off[s];
        const int64_t n = seq_off[s + 1] - seq_off[s];
        out_cnt[s * strands] = mini_core(
            seq, n, k, w, out_pos + cap_off[s * strands],
            out_hash + cap_off[s * strands], h, dq);
        if (both_strands) {
          if (static_cast<int64_t>(rcbuf.size()) < n)
            rcbuf.resize(static_cast<size_t>(n));
          for (int64_t i = 0; i < n; i++)
            rcbuf[static_cast<size_t>(i)] =
                static_cast<uint8_t>(3 - (seq[n - 1 - i] & 3));
          out_cnt[s * strands + 1] = mini_core(
              rcbuf.data(), n, k, w, out_pos + cap_off[s * strands + 1],
              out_hash + cap_off[s * strands + 1], h, dq);
        }
      }
    }
  };
  if (n_threads == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  // compact forward (write offsets only ever shrink)
  int64_t wpos = 0;
  for (int64_t s = 0; s < n_streams; s++) {
    const int64_t cnt = out_cnt[s];
    const int64_t src = cap_off[s];
    if (src != wpos && cnt > 0) {
      std::memmove(out_pos + wpos, out_pos + src, cnt * sizeof(int32_t));
      std::memmove(out_hash + wpos, out_hash + src, cnt * sizeof(uint64_t));
    }
    wpos += cnt;
  }
  return wpos;
}

// Stable LSD radix sort of (hash, packed) by hash (4 passes of 16 bits) +
// repetitive-bucket filter (runs of equal hash longer than max_bucket are
// dropped).  Matches mapper.build_index's stable argsort + run-length
// filter bit-for-bit.  Returns the filtered count, or -1 on alloc failure.
int64_t index_sort_filter(uint64_t* hash, uint64_t* packed, int64_t n,
                          int64_t max_bucket) {
  if (n <= 0) return 0;
  std::vector<uint64_t> h2, p2;
  try {
    h2.resize(static_cast<size_t>(n));
    p2.resize(static_cast<size_t>(n));
  } catch (...) {
    return -1;
  }
  uint64_t* hs = hash;
  uint64_t* ps = packed;
  uint64_t* hd = h2.data();
  uint64_t* pd = p2.data();
  // split radix: each thread counts and scatters its own input half with
  // per-thread bucket bases (thread 0's elements precede thread 1's in
  // every bucket), so the pass stays STABLE and bit-identical to the
  // single-thread order while both cores stream memory
  unsigned hw = std::thread::hardware_concurrency();
  const int nt = (hw >= 2 && n > (1 << 20)) ? 2 : 1;
  std::vector<std::vector<int64_t>> counts(
      static_cast<size_t>(nt), std::vector<int64_t>(1 << 16));
  const int64_t half = n / nt;
  for (int pass = 0; pass < 4; pass++) {
    const int shift = 16 * pass;
    auto count_part = [&](int t) {
      auto& cnt = counts[static_cast<size_t>(t)];
      std::fill(cnt.begin(), cnt.end(), 0);
      const int64_t lo = t * half, hi = (t == nt - 1) ? n : (t + 1) * half;
      for (int64_t i = lo; i < hi; i++) cnt[(hs[i] >> shift) & 0xFFFF]++;
    };
    auto scatter_part = [&](int t) {
      auto& cnt = counts[static_cast<size_t>(t)];
      const int64_t lo = t * half, hi = (t == nt - 1) ? n : (t + 1) * half;
      for (int64_t i = lo; i < hi; i++) {
        const int64_t d = cnt[(hs[i] >> shift) & 0xFFFF]++;
        hd[d] = hs[i];
        pd[d] = ps[i];
      }
    };
    if (nt == 1) {
      count_part(0);
      int64_t acc = 0;
      auto& cnt = counts[0];
      for (int64_t b = 0; b < (1 << 16); b++) {
        const int64_t c = cnt[static_cast<size_t>(b)];
        cnt[static_cast<size_t>(b)] = acc;
        acc += c;
      }
      scatter_part(0);
    } else {
      std::thread th(count_part, 1);
      count_part(0);
      th.join();
      int64_t acc = 0;
      for (int64_t b = 0; b < (1 << 16); b++) {
        for (int t = 0; t < nt; t++) {
          const int64_t c = counts[static_cast<size_t>(t)][static_cast<size_t>(b)];
          counts[static_cast<size_t>(t)][static_cast<size_t>(b)] = acc;
          acc += c;
        }
      }
      std::thread th2(scatter_part, 1);
      scatter_part(0);
      th2.join();
    }
    std::swap(hs, hd);
    std::swap(ps, pd);
  }
  // 4 swaps: data is back in (hash, packed)
  int64_t wpos = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && hash[j] == hash[i]) j++;
    if (j - i <= max_bucket) {
      if (wpos != i)
        for (int64_t x = i; x < j; x++) {
          hash[wpos + (x - i)] = hash[x];
          packed[wpos + (x - i)] = packed[x];
        }
      wpos += j - i;
    }
    i = j;
  }
  return wpos;
}

// ---- minimizer hit join + diagonal-band chaining (mapper._map_block) ----
// The all-vs-all hot loop: for every query minimizer, walk its index bucket
// and histogram hits into (target, strand, diagonal-band) groups.  All state
// is per-READ (small, cache-resident) — no global hit table is ever
// materialized, unlike the numpy fallback which builds the full join.
// Accepted groups (best adjacent band pair >= min_hits) emit their banded
// hits, subsampled to >= sub_gap bp apart on the query (first and last hit
// always kept: span endpoints).  Semantics match mapper._map_block steps
// 2-4 (reference has no equivalent; DALIGNER is external, SURVEY.md L0).

static constexpr uint64_t kBandBits = 25;  // band < 2^31/band_width < 2^25

struct LocalMap {
  // open-addressing (key -> count/accept_row), epoch-tagged so reads reset
  // in O(1); grows geometrically and never shrinks across reads
  std::vector<uint64_t> key;
  std::vector<uint32_t> epoch;
  std::vector<int32_t> count;
  std::vector<int32_t> accept_row;
  uint64_t mask = 0;
  uint32_t cur_epoch = 0;
  size_t used = 0;

  void init(size_t cap_pow2) {
    key.assign(cap_pow2, 0);
    epoch.assign(cap_pow2, 0);
    count.assign(cap_pow2, 0);
    accept_row.assign(cap_pow2, -1);
    mask = cap_pow2 - 1;
  }
  void new_read() { cur_epoch++; used = 0; }
  size_t slot(uint64_t k_) const {
    uint64_t h = k_ * 0x9E3779B97F4A7C15ULL;
    return static_cast<size_t>((h >> 17) & mask);
  }
  // returns slot index; inserts with count 0 if fresh this epoch
  size_t find_or_insert(uint64_t k_, bool* fresh) {
    size_t s = slot(k_);
    for (;;) {
      if (epoch[s] != cur_epoch) {
        key[s] = k_;
        epoch[s] = cur_epoch;
        count[s] = 0;
        accept_row[s] = -1;
        *fresh = true;
        used++;
        return s;
      }
      if (key[s] == k_) {
        *fresh = false;
        return s;
      }
      s = (s + 1) & mask;
    }
  }
  // lookup only; returns SIZE_MAX if absent this epoch
  size_t find(uint64_t k_) const {
    size_t s = slot(k_);
    for (;;) {
      if (epoch[s] != cur_epoch) return SIZE_MAX;
      if (key[s] == k_) return s;
      s = (s + 1) & mask;
    }
  }
};

struct HitRec {
  uint64_t key;
  int32_t q, t;
};

struct ChainOut {
  std::vector<int32_t> row, q, t, rid, strand;
  std::vector<int64_t> tid;
};

// Chain reads [r0, r1) into private output vectors (one worker's share).
// pre/pre_shift: hash-prefix bucket table over the sorted index — bucket b
// spans idx_hash[pre[b] : pre[b+1]], b = hash >> pre_shift.  Replaces the
// full-index lower_bound (log2(n_idx) cache misses per query minimizer)
// with ~2 misses: the measured hot spot of the all-vs-all overlap stage.
static void chain_read_range(
    const uint64_t* idx_hash, const uint64_t* idx_packed, int64_t n_idx,
    const int64_t* pre, int pre_shift,
    const uint64_t* qh, const int32_t* qpos, const int64_t* stream_off,
    int64_t r0, int64_t r1, int64_t rid_base, int32_t half_pairs,
    int32_t band_width, int32_t min_hits, int32_t sub_gap, ChainOut& out) {
  const uint64_t kMask40 = (1ULL << 40) - 1;
  LocalMap lm;
  lm.init(1 << 14);
  std::vector<HitRec> buf;
  std::vector<uint64_t> keys;
  std::vector<int32_t> row_last_emit_q, row_last_seen_q, row_last_seen_t;
  int64_t n_groups = 0;

  static const bool kProf = getenv("HINGE_NATIVE_PROF") != nullptr;
  double t_lookup = 0, t_eval = 0, t_emit = 0;
  int64_t n_lookups = 0, n_hits = 0;
  auto now = []{ return std::chrono::duration<double>(std::chrono::steady_clock::now().time_since_epoch()).count(); };
  for (int64_t r = r0; r < r1; r++) {
    double tA = kProf ? now() : 0;
    lm.new_read();
    buf.clear();
    keys.clear();
    const uint64_t min_tid =
        half_pairs ? static_cast<uint64_t>(r + rid_base) : 0;
    for (int s = 0; s < 2; s++) {
      const int64_t st = stream_off[2 * r + s], en = stream_off[2 * r + s + 1];
      for (int64_t i = st; i < en; i++) {
        // two-stage software pipeline: touch the prefix slot ~8 ahead and
        // the bucket payload ~4 ahead so the ~2 dependent misses per
        // lookup overlap with current work
        if (i + 8 < en) __builtin_prefetch(&pre[qh[i + 8] >> pre_shift]);
        if (i + 4 < en) {
          const int64_t p4 = pre[qh[i + 4] >> pre_shift];
          __builtin_prefetch(idx_hash + p4);
          __builtin_prefetch(idx_packed + p4);
        }
        const uint64_t h = qh[i];
        if (kProf) n_lookups++;
        const uint64_t b = h >> pre_shift;
        const uint64_t* lo =
            std::lower_bound(idx_hash + pre[b], idx_hash + pre[b + 1], h);
        const uint64_t* bucket_end = idx_hash + pre[b + 1];
        const uint64_t* hi = lo;
        while (hi < bucket_end && *hi == h) hi++;
        const int32_t qp = qpos[i];
        for (const uint64_t* e = lo; e < hi; e++) {
          const uint64_t packed = idx_packed[e - idx_hash];
          const uint64_t tid = packed >> 40;
          if (tid < min_tid) continue;
          const int64_t tpos = static_cast<int64_t>(packed & kMask40);
          if (kProf) n_hits++;
          const uint64_t band =
              static_cast<uint64_t>(tpos - qp + (1LL << 30)) /
              static_cast<uint32_t>(band_width);
          const uint64_t k_ =
              (((tid << 1) | static_cast<uint64_t>(s)) << kBandBits) | band;
          bool fresh;
          // grow before the table saturates (load factor 0.7)
          if (lm.used * 10 > lm.mask * 7) {
            std::vector<HitRec> snapshot(buf);
            lm.init((lm.mask + 1) * 2);
            lm.new_read();
            keys.clear();
            for (const HitRec& hr : snapshot) {
              size_t sl = lm.find_or_insert(hr.key, &fresh);
              if (fresh) keys.push_back(hr.key);
              lm.count[sl]++;
            }
          }
          size_t sl = lm.find_or_insert(k_, &fresh);
          if (fresh) keys.push_back(k_);
          lm.count[sl]++;
          buf.push_back({k_, qp, static_cast<int32_t>(tpos)});
        }
      }
    }
    if (kProf) t_lookup += now() - tA;
    if (keys.empty()) continue;
    double tB = kProf ? now() : 0;

    // evaluate groups: best adjacent band pair per (tid, strand)
    std::sort(keys.begin(), keys.end());
    const int64_t row_base = n_groups;
    size_t gi = 0;
    while (gi < keys.size()) {
      size_t gj = gi;
      const uint64_t grp = keys[gi] >> kBandBits;
      while (gj < keys.size() && (keys[gj] >> kBandBits) == grp) gj++;
      int32_t best = -1;
      size_t best_i = gi;
      for (size_t x = gi; x < gj; x++) {
        int32_t c = lm.count[lm.find(keys[x])];
        if (x + 1 < gj && keys[x + 1] == keys[x] + 1)
          c += lm.count[lm.find(keys[x + 1])];
        if (c > best) {
          best = c;
          best_i = x;
        }
      }
      if (best >= min_hits) {
        const int32_t row = static_cast<int32_t>(n_groups - row_base);
        lm.accept_row[lm.find(keys[best_i])] = row;
        if (best_i + 1 < gj && keys[best_i + 1] == keys[best_i] + 1)
          lm.accept_row[lm.find(keys[best_i + 1])] = row;
        out.rid.push_back(static_cast<int32_t>(r));
        out.strand.push_back(static_cast<int32_t>(grp & 1));
        out.tid.push_back(static_cast<int64_t>(grp >> 1));
        n_groups++;
      }
      gi = gj;
    }
    if (kProf) t_eval += now() - tB;
    const int64_t rows_here = n_groups - row_base;
    if (rows_here == 0) continue;
    double tC = kProf ? now() : 0;

    // emit banded hits, subsampled to sub_gap bp on the query axis
    row_last_emit_q.assign(rows_here, INT32_MIN);
    row_last_seen_q.assign(rows_here, INT32_MIN);
    row_last_seen_t.assign(rows_here, 0);
    for (const HitRec& hr : buf) {
      const size_t sl = lm.find(hr.key);
      const int32_t row = lm.accept_row[sl];
      if (row < 0) continue;
      row_last_seen_q[row] = hr.q;
      row_last_seen_t[row] = hr.t;
      if (row_last_emit_q[row] != INT32_MIN &&
          hr.q - row_last_emit_q[row] < sub_gap)
        continue;
      out.row.push_back(static_cast<int32_t>(row_base + row));
      out.q.push_back(hr.q);
      out.t.push_back(hr.t);
      row_last_emit_q[row] = hr.q;
    }
    for (int64_t row = 0; row < rows_here; row++) {
      if (row_last_seen_q[row] != INT32_MIN &&
          row_last_seen_q[row] != row_last_emit_q[row]) {
        out.row.push_back(static_cast<int32_t>(row_base + row));
        out.q.push_back(row_last_seen_q[row]);
        out.t.push_back(row_last_seen_t[row]);
      }
    }
    if (kProf) t_emit += now() - tC;
  }
  if (kProf)
    fprintf(stderr, "chain[%ld,%ld): lookup %.2fs eval %.2fs emit %.2fs lookups %lld hits %lld\n", (long)r0, (long)r1, t_lookup, t_eval, t_emit, (long long)n_lookups, (long long)n_hits);
}

// Returns n_groups (>= 0) or -1 if an output capacity was exceeded (caller
// retries with larger buffers).  Query minimizers arrive as 2*n_reads
// streams (read-major, strand 0 then 1), stream s spanning
// qh[stream_off[s] : stream_off[s+1]].  Internally parallel over reads:
// worker threads pull contiguous read chunks from a shared queue (dynamic —
// half_pairs makes low-rid reads heavier) and results merge in chunk order,
// so the output is deterministic and read-major regardless of thread count.
int64_t map_block_hits(
    const uint64_t* idx_hash, const uint64_t* idx_packed, int64_t n_idx,
    const uint64_t* qh, const int32_t* qpos,
    const int64_t* stream_off, int64_t n_reads,
    int64_t rid_base, int32_t half_pairs,
    int32_t band_width, int32_t min_hits, int32_t sub_gap,
    int32_t* out_row, int32_t* out_q, int32_t* out_t, int64_t cap_hits,
    int32_t* out_rid, int32_t* out_strand, int64_t* out_tid,
    int64_t cap_groups, int64_t* n_hits_out) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? (hw > 8 ? 8 : hw) : 1);
  if (n_reads < 64) n_threads = 1;
  const int64_t n_chunks =
      n_threads == 1 ? 1 : std::min<int64_t>(n_reads, 4 * n_threads);
  const int64_t chunk = (n_reads + n_chunks - 1) / n_chunks;
  std::vector<ChainOut> parts(static_cast<size_t>(n_chunks));
  std::atomic<int64_t> next{0};

  // hash-prefix bucket table (shared read-only by all workers): size the
  // prefix so buckets average ~2 entries; one counting pass + prefix sum
  int pre_bits = 1;
  while (pre_bits < 24 && (n_idx >> pre_bits) > 2) pre_bits++;
  const int pre_shift = 64 - pre_bits;
  std::vector<int64_t> pre((1ULL << pre_bits) + 1, 0);
  for (int64_t i = 0; i < n_idx; i++) pre[(idx_hash[i] >> pre_shift) + 1]++;
  for (size_t b = 1; b < pre.size(); b++) pre[b] += pre[b - 1];

  auto work = [&]() {
    for (;;) {
      const int64_t c = next.fetch_add(1);
      if (c >= n_chunks) break;
      const int64_t r0 = c * chunk;
      const int64_t r1 = std::min(n_reads, r0 + chunk);
      chain_read_range(idx_hash, idx_packed, n_idx, pre.data(), pre_shift,
                       qh, qpos, stream_off,
                       r0, r1, rid_base, half_pairs, band_width, min_hits,
                       sub_gap, parts[static_cast<size_t>(c)]);
    }
  };
  if (n_threads == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }

  int64_t n_groups = 0, n_hits = 0;
  for (const ChainOut& p : parts) {
    n_groups += static_cast<int64_t>(p.rid.size());
    n_hits += static_cast<int64_t>(p.row.size());
  }
  if (n_groups > cap_groups || n_hits > cap_hits) return -1;
  int64_t go = 0, ho = 0;
  for (const ChainOut& p : parts) {
    const int64_t pg = static_cast<int64_t>(p.rid.size());
    const int64_t ph = static_cast<int64_t>(p.row.size());
    std::memcpy(out_rid + go, p.rid.data(), pg * sizeof(int32_t));
    std::memcpy(out_strand + go, p.strand.data(), pg * sizeof(int32_t));
    std::memcpy(out_tid + go, p.tid.data(), pg * sizeof(int64_t));
    std::memcpy(out_q + ho, p.q.data(), ph * sizeof(int32_t));
    std::memcpy(out_t + ho, p.t.data(), ph * sizeof(int32_t));
    // row ids are chunk-local; shift by the groups emitted before this chunk
    for (int64_t i = 0; i < ph; i++)
      out_row[ho + i] = static_cast<int32_t>(p.row[static_cast<size_t>(i)] + go);
    go += pg;
    ho += ph;
  }
  *n_hits_out = n_hits;
  return n_groups;
}

// ---- record emission (mapper._emit_records) ----
// Stable (row, q) sort, per-group monotone-t filter, span check, and
// tspace-grid trace-point interpolation.  Bit-identical to the numpy tail
// (same float64 expression order; round half-to-even via nearbyint).
// Traces are written contiguously for accepted groups in group order;
// returns 0, or -1 if trace_cap is too small (*trace_total = needed).
int64_t emit_records(const int32_t* row, const int32_t* q, const int32_t* t,
                     int64_t n_hits, int64_t n_groups, int32_t k,
                     int32_t min_span, int32_t min_cnt, int32_t tspace,
                     uint8_t* ok, int64_t* q0o, int64_t* q1o, int64_t* t0o,
                     int64_t* t1o, int64_t* nbo, uint16_t* trace,
                     int64_t trace_cap, int64_t* trace_total) {
  struct QT {
    int32_t q, t;
  };
  std::vector<int64_t> off(static_cast<size_t>(n_groups) + 1, 0);
  for (int64_t i = 0; i < n_hits; i++) off[static_cast<size_t>(row[i]) + 1]++;
  for (int64_t g = 0; g < n_groups; g++)
    off[static_cast<size_t>(g) + 1] += off[static_cast<size_t>(g)];
  std::vector<QT> hits(static_cast<size_t>(n_hits));
  {
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t i = 0; i < n_hits; i++) {
      const int64_t d = cur[static_cast<size_t>(row[i])]++;
      hits[static_cast<size_t>(d)] = {q[i], t[i]};
    }
  }
  std::vector<int64_t> m(static_cast<size_t>(n_groups), 0);

  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? (hw > 8 ? 8 : hw) : 1);
  if (n_groups < 256) n_threads = 1;
  const int64_t chunk = 256;
  std::atomic<int64_t> next{0};
  auto phase_a = [&]() {
    for (;;) {
      const int64_t c = next.fetch_add(1);
      const int64_t g0 = c * chunk;
      if (g0 >= n_groups) break;
      const int64_t g1 = std::min(n_groups, g0 + chunk);
      for (int64_t g = g0; g < g1; g++) {
        QT* a = hits.data() + off[static_cast<size_t>(g)];
        const int64_t n = off[static_cast<size_t>(g) + 1] - off[static_cast<size_t>(g)];
        if (n == 0) {
          ok[g] = 0;
          nbo[g] = 0;
          continue;
        }
        std::stable_sort(a, a + n,
                         [](const QT& x, const QT& y) { return x.q < y.q; });
        // monotone-t filter (cummax == t keeps first of each plateau)
        int64_t w_ = 0;
        int32_t tmax = INT32_MIN;
        for (int64_t i = 0; i < n; i++) {
          if (a[i].t >= tmax) {
            tmax = a[i].t;
            a[w_++] = a[i];
          }
        }
        m[static_cast<size_t>(g)] = w_;
        const int64_t Q0 = a[0].q, Q1 = a[w_ - 1].q + k;
        const int64_t T0 = a[0].t, T1 = a[w_ - 1].t + k;
        q0o[g] = Q0;
        q1o[g] = Q1;
        t0o[g] = T0;
        t1o[g] = T1;
        const bool good = w_ >= min_cnt && (Q1 - Q0) >= min_span &&
                          (T1 - T0) >= min_span;
        ok[g] = good ? 1 : 0;
        const int64_t n_int =
            good ? std::max<int64_t>((T1 - 1) / tspace - T0 / tspace, 0) : 0;
        nbo[g] = good ? n_int + 2 : 0;
      }
    }
  };
  auto run_pool = [&](auto fn) {
    next.store(0);
    if (n_threads == 1) {
      fn();
    } else {
      std::vector<std::thread> pool;
      for (int i = 0; i < n_threads; i++) pool.emplace_back(fn);
      for (auto& th : pool) th.join();
    }
  };
  run_pool(phase_a);

  // trace offsets (accepted groups, contiguous, group order)
  std::vector<int64_t> toff(static_cast<size_t>(n_groups) + 1, 0);
  for (int64_t g = 0; g < n_groups; g++)
    toff[static_cast<size_t>(g) + 1] =
        toff[static_cast<size_t>(g)] + (ok[g] ? 2 * (nbo[g] - 1) : 0);
  *trace_total = toff[static_cast<size_t>(n_groups)];
  if (*trace_total > trace_cap) return -1;

  auto phase_b = [&]() {
    std::vector<int64_t> bar;
    for (;;) {
      const int64_t c = next.fetch_add(1);
      const int64_t g0 = c * chunk;
      if (g0 >= n_groups) break;
      const int64_t g1 = std::min(n_groups, g0 + chunk);
      for (int64_t g = g0; g < g1; g++) {
        if (!ok[g]) continue;
        const QT* a = hits.data() + off[static_cast<size_t>(g)];
        const int64_t n = m[static_cast<size_t>(g)];
        const int64_t nbg = nbo[g];
        const int64_t T0 = t0o[g], T1 = t1o[g];
        const int64_t Q0 = q0o[g], Q1 = q1o[g];
        if (static_cast<int64_t>(bar.size()) < nbg) bar.resize(static_cast<size_t>(nbg));
        int64_t jh = 0;
        for (int64_t j = 0; j < nbg; j++) {
          const int64_t b = (j == 0) ? T0
                            : (j == nbg - 1)
                                ? T1
                                : (T0 / tspace + j) * tspace;
          while (jh + 1 < n && a[jh + 1].t <= b) jh++;
          // INTEGER-EXACT interpolation (round-half-even of the exact
          // rational q[jh] + (b-t[jh])*dy/denom).  Replaces the r1-r4
          // double evaluation so the TPU device-join path — where IEEE
          // binary64 is not reliably available — can reproduce records
          // bit-for-bit across backends by construction.  All quantities
          // are non-negative (b >= t[jh] by the jh walk; q ascending).
          int64_t bv;
          if (j == 0) {
            bv = Q0;
          } else if (j == nbg - 1) {
            bv = Q1;
          } else if (jh >= n - 1) {
            bv = a[jh].q;
          } else {
            const int64_t denom = std::max<int64_t>(a[jh + 1].t - a[jh].t, 1);
            const int64_t num =
                static_cast<int64_t>(a[jh].q) * denom +
                (b - a[jh].t) * static_cast<int64_t>(a[jh + 1].q - a[jh].q);
            int64_t qd = num / denom;
            const int64_t r2 = 2 * (num - qd * denom);
            if (r2 > denom || (r2 == denom && (qd & 1))) qd++;
            bv = qd;
          }
          bar[static_cast<size_t>(j)] = bv;
        }
        uint16_t* tr = trace + toff[static_cast<size_t>(g)];
        int64_t dsum = 0;
        for (int64_t j = 0; j < nbg - 1; j++) {
          int64_t d = bar[static_cast<size_t>(j + 1)] - bar[static_cast<size_t>(j)];
          d = std::min<int64_t>(std::max<int64_t>(d, 0), 65534);
          tr[2 * j] = 0;
          tr[2 * j + 1] = static_cast<uint16_t>(d);
          dsum += d;
        }
        const int64_t delta = (Q1 - Q0) - dsum;
        const int64_t newlast = tr[2 * (nbg - 2) + 1] + delta;
        if (newlast >= 0 && newlast < 65535)
          tr[2 * (nbg - 2) + 1] = static_cast<uint16_t>(newlast);
      }
    }
  };
  run_pool(phase_b);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched banded Myers O(ND) alignment — native transcription of
// hinge_tpu/ops/myers.py (align_pair + align_full), which models the
// reference's vendored FALCON aligner src/lib/DW_banded.c:_align.  Exact
// same furthest-reaching-diagonal recurrence, predecessor tie-breaking,
// adaptive band pruning, and align_full gap-padding semantics, so the
// Python and native paths produce byte-identical alignment rows.
// ---------------------------------------------------------------------------

extern "C" {

namespace {

struct DPathEntry {
  int32_t x1, y1, x2, y2, pre_k;
};

constexpr uint8_t kGap = 4;

// Aligns one window.  pad_full != 0: align_full-style rows (leading/trailing
// pads so every base of q and t appears; not-aligned -> disjoint fallback).
// pad_full == 0: EXACT DW_banded.c:_align rows — only the aligned core, no
// pads, not-aligned -> empty rows (the reference returns aln_str_size = 0).
// *ok = 0 marks not-aligned.
int64_t myers_one(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                  int32_t band_tolerance, uint8_t* qr, uint8_t* tr,
                  int32_t* ok, DPathEntry* d_path, int64_t* V, int64_t* U,
                  int32_t pad_full) {
  *ok = 1;
  if (m == 0 && n == 0) return 0;
  const int64_t max_d = static_cast<int64_t>(0.3 * static_cast<double>(m + n));
  const int64_t band_size = static_cast<int64_t>(band_tolerance) * 2;
  const int64_t ko = max_d;  // k offset
  std::fill(V, V + 2 * max_d + 2, 0);
  std::fill(U, U + 2 * max_d + 2, 0);
  // d_path[(d, k)] lives at offset d*(d+1)/2 + (k+d)/2 (k has parity of d);
  // entries are written before any backtrack read, no init needed
  int64_t best_m = -1;
  int64_t min_k = 0, max_k = 0;
  bool aligned = false;
  int64_t x = 0, y = 0, k = 0, d = 0;
  for (d = 0; d < max_d; d++) {
    if (max_k - min_k > band_size) break;
    const int64_t doff = d * (d + 1) / 2;
    for (k = min_k; k <= max_k; k += 2) {
      int32_t pre_k;
      if (k == min_k || (k != max_k && V[k - 1 + ko] < V[k + 1 + ko])) {
        pre_k = static_cast<int32_t>(k + 1);
        x = V[k + 1 + ko];
      } else {
        pre_k = static_cast<int32_t>(k - 1);
        x = V[k - 1 + ko] + 1;
      }
      y = x - k;
      const int64_t x1 = x, y1 = y;
      if (x >= 0 && y >= 0) {
        while (x < m && y < n && q[x] == t[y]) {
          x++;
          y++;
        }
      }
      DPathEntry& e = d_path[doff + (k + d) / 2];
      e.x1 = static_cast<int32_t>(x1);
      e.y1 = static_cast<int32_t>(y1);
      e.x2 = static_cast<int32_t>(x);
      e.y2 = static_cast<int32_t>(y);
      e.pre_k = pre_k;
      V[k + ko] = x;
      U[k + ko] = x + y;
      if (x + y > best_m) best_m = x + y;
      if (x >= m || y >= n) {
        aligned = true;
        break;
      }
    }
    if (aligned) break;
    int64_t new_min_k = max_k, new_max_k = min_k;
    for (int64_t k2 = min_k; k2 <= max_k; k2 += 2) {
      if (U[k2 + ko] >= best_m - band_tolerance) {
        if (k2 < new_min_k) new_min_k = k2;
        if (k2 > new_max_k) new_max_k = k2;
      }
    }
    max_k = new_max_k + 1;
    min_k = new_min_k - 1;
  }

  int64_t L = 0;
  if (!aligned) {
    *ok = 0;
    if (!pad_full) return 0;
    for (int64_t i = 0; i < m; i++) {
      qr[L] = q[i];
      tr[L] = kGap;
      L++;
    }
    for (int64_t j = 0; j < n; j++) {
      qr[L] = kGap;
      tr[L] = t[j];
      L++;
    }
    return L;
  }

  // backtrack: pairs (x1,y1),(x2,y2) per level, oldest first
  std::vector<int32_t> path;  // flattened (x, y) pairs
  path.reserve(4 * (d + 1));
  {
    int64_t cd = d, ck = k;
    while (cd >= 0) {
      const DPathEntry& e = d_path[cd * (cd + 1) / 2 + (ck + cd) / 2];
      path.push_back(e.x2);
      path.push_back(e.y2);
      path.push_back(e.x1);
      path.push_back(e.y1);
      ck = e.pre_k;
      cd--;
    }
  }
  // path holds (x2,y2,x1,y1) newest-first; walk it oldest-first
  const int64_t npts = static_cast<int64_t>(path.size()) / 2;
  auto px = [&](int64_t i) { return path[2 * (npts - 1 - i)]; };
  auto py = [&](int64_t i) { return path[2 * (npts - 1 - i) + 1]; };
  int64_t cx = px(0), cy = py(0);
  const int64_t q_s = cx, t_s = cy;
  // leading skipped prefix (align_full)
  if (pad_full && (q_s || t_s)) {
    for (int64_t i = 0; i < q_s; i++) {
      qr[L] = q[i];
      tr[L] = kGap;
      L++;
    }
    for (int64_t j = 0; j < t_s; j++) {
      qr[L] = kGap;
      tr[L] = t[j];
      L++;
    }
  }
  for (int64_t i = 1; i < npts; i++) {
    const int64_t nx = px(i), ny = py(i);
    if (nx == cx && ny == cy) continue;
    if (nx == cx) {
      for (int64_t j = cy; j < ny; j++) {
        qr[L] = kGap;
        tr[L] = t[j];
        L++;
      }
    } else if (ny == cy) {
      for (int64_t j = cx; j < nx; j++) {
        qr[L] = q[j];
        tr[L] = kGap;
        L++;
      }
    } else {
      for (int64_t j = 0; j < nx - cx; j++) {
        qr[L] = q[cx + j];
        tr[L] = t[cy + j];
        L++;
      }
    }
    cx = nx;
    cy = ny;
  }
  // trailing pads (align_full): q_e = x, t_e = y
  if (!pad_full) return L;
  if (x < m) {
    for (int64_t i = x; i < m; i++) {
      qr[L] = q[i];
      tr[L] = kGap;
      L++;
    }
  }
  if (y < n) {
    for (int64_t j = y; j < n; j++) {
      qr[L] = kGap;
      tr[L] = t[j];
      L++;
    }
  }
  return L;
}

}  // namespace

// Batch: windows given as concatenated bytes + (B+1) offsets.  Rows are
// packed at row_off (written by this function, B+1 entries); the caller
// must size q_rows/t_rows to q_off[B] + t_off[B] (the worst case: every
// column a gap).  ok[i] = 0 marks the degenerate not-aligned fallback.
// Returns the total packed row length.
int64_t myers_align_batch(const uint8_t* q, const int64_t* q_off,
                          const uint8_t* t, const int64_t* t_off, int64_t B,
                          int32_t band_tolerance, uint8_t* q_rows,
                          uint8_t* t_rows, int64_t* row_off, int32_t* ok,
                          int32_t pad_full) {
  int64_t max_mn = 0;
  for (int64_t i = 0; i < B; i++) {
    const int64_t mn =
        (q_off[i + 1] - q_off[i]) + (t_off[i + 1] - t_off[i]);
    if (mn > max_mn) max_mn = mn;
  }
  const int64_t dmax = static_cast<int64_t>(0.3 * static_cast<double>(max_mn));
  std::vector<DPathEntry> d_path(static_cast<size_t>(dmax) * (dmax + 1) / 2 +
                                 1);
  std::vector<int64_t> V(2 * dmax + 2), U(2 * dmax + 2);
  row_off[0] = 0;
  for (int64_t i = 0; i < B; i++) {
    const int64_t L = myers_one(
        q + q_off[i], q_off[i + 1] - q_off[i], t + t_off[i],
        t_off[i + 1] - t_off[i], band_tolerance, q_rows + row_off[i],
        t_rows + row_off[i], ok + i, d_path.data(), V.data(), U.data(),
        pad_full);
    row_off[i + 1] = row_off[i] + L;
  }
  return row_off[B];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched FALCON align-tag consensus — native transcription of
// hinge_tpu/ops/falcon_vote.py:get_cns_from_align_tags (itself the model of
// the reference's vendored src/lib/falcon.c get_cns_from_align_tags,
// falcon.c:270-520).  Tag rows are encoded into one 64-bit key whose field
// order matches the Python path's lexsort (t_pos, delta, q_base, p_q_base,
// p_delta, p_t_pos), sorted, and run-length-counted; the link DP then runs
// over the unique rows in that exact order, so scores, tie-breaking, and
// the backtracked consensus are byte-identical to the numpy path.
// ---------------------------------------------------------------------------

extern "C" {

namespace {

constexpr int64_t kCnsMaxTPos = (1LL << 21) - 2;

struct CnsScratch {
  std::vector<std::pair<uint64_t, int64_t>> keys;  // (key, stream index)
  std::vector<int64_t> cov;
  std::vector<uint64_t> ukey;
  std::vector<int64_t> ucnt;
  std::vector<int64_t> ufirst;    // first stream index of each unique link
  std::vector<uint64_t> colkey;   // (tp<<11)|(dl<<3)|qb per unique column
  std::vector<int64_t> colstart;  // index into ukey of each column's first row
  std::vector<int64_t> lorder;    // per-column link order (by first index)
  std::vector<double> colscore;
  std::vector<int32_t> bl_pi, bl_pj, bl_pb, bl_ck;
  std::vector<uint8_t> bl_none;
};

// One window.  rows = (n,6) int32 tag rows; writes consensus codes + low
// mask (cap 2*tlen) and the emitted length, or -1 when the window needs the
// Python fallback (t_pos out of key range).
void cns_one(const int32_t* rows, int64_t n, int64_t tlen, int64_t mincov,
             uint8_t* seq, uint8_t* low, int64_t* out_len, CnsScratch& s) {
  *out_len = 0;
  if (n == 0) return;
  if (tlen <= 0 || tlen > kCnsMaxTPos) {
    *out_len = -1;
    return;
  }
  s.cov.assign(static_cast<size_t>(tlen), 0);
  s.keys.resize(static_cast<size_t>(n));
  for (int64_t r = 0; r < n; r++) {
    const int32_t* t = rows + 6 * r;
    const int64_t tp = t[0], dl = t[1], pt = t[2], pdl = t[3];
    const int64_t pqb = t[4] > 4 ? 4 : t[4];
    const int64_t qb = t[5] > 4 ? 4 : t[5];
    if (tp < 0 || tp > kCnsMaxTPos || dl > 255 || pdl > 255 || pt < -1 ||
        pt > kCnsMaxTPos) {
      *out_len = -1;
      return;
    }
    if (dl == 0 && tp < tlen) s.cov[static_cast<size_t>(tp)]++;
    s.keys[static_cast<size_t>(r)] = {
        (static_cast<uint64_t>(tp) << 43) | (static_cast<uint64_t>(dl) << 35) |
            (static_cast<uint64_t>(qb) << 32) |
            (static_cast<uint64_t>(pqb) << 29) |
            (static_cast<uint64_t>(pdl) << 21) | static_cast<uint64_t>(pt + 1),
        r};
  }
  std::sort(s.keys.begin(), s.keys.end());
  // run-length unique + counts + first stream index; column boundaries on
  // key>>32 = (tp,dl,qb)
  s.ukey.clear();
  s.ucnt.clear();
  s.ufirst.clear();
  s.colkey.clear();
  s.colstart.clear();
  for (int64_t r = 0; r < n;) {
    const uint64_t k = s.keys[static_cast<size_t>(r)].first;
    int64_t e = r + 1;
    while (e < n && s.keys[static_cast<size_t>(e)].first == k) e++;
    if (s.ukey.empty() || (s.ukey.back() >> 32) != (k >> 32)) {
      const uint64_t tp = k >> 43, dl = (k >> 35) & 0xFF, qb = (k >> 32) & 7;
      s.colkey.push_back((tp << 11) | (dl << 3) | qb);
      s.colstart.push_back(static_cast<int64_t>(s.ukey.size()));
    }
    s.ukey.push_back(k);
    s.ucnt.push_back(e - r);
    s.ufirst.push_back(s.keys[static_cast<size_t>(r)].second);
    r = e;
  }
  const int64_t n_cols = static_cast<int64_t>(s.colkey.size());
  s.colstart.push_back(static_cast<int64_t>(s.ukey.size()));
  s.colscore.assign(static_cast<size_t>(n_cols), 0.0);
  s.bl_pi.assign(static_cast<size_t>(n_cols), 0);
  s.bl_pj.assign(static_cast<size_t>(n_cols), 0);
  s.bl_pb.assign(static_cast<size_t>(n_cols), 0);
  s.bl_ck.assign(static_cast<size_t>(n_cols), -1);
  s.bl_none.assign(static_cast<size_t>(n_cols), 1);

  double g_best_score = -1.0;
  int64_t g_best_col = -1;
  for (int64_t c = 0; c < n_cols; c++) {
    const int64_t tp = static_cast<int64_t>(s.colkey[static_cast<size_t>(c)] >> 11);
    const double covh = tp < tlen ? s.cov[static_cast<size_t>(tp)] * 0.5 : 0.0;
    double best_score = -1.0;
    bool have = false;
    // links must be visited in update_col append order = first stream
    // appearance (falcon.c:192-225): equal-score ties keep the earliest
    const int64_t cs = s.colstart[static_cast<size_t>(c)];
    const int64_t ce = s.colstart[static_cast<size_t>(c + 1)];
    s.lorder.resize(static_cast<size_t>(ce - cs));
    for (int64_t u = cs; u < ce; u++) s.lorder[static_cast<size_t>(u - cs)] = u;
    std::sort(s.lorder.begin(), s.lorder.end(), [&](int64_t x, int64_t y) {
      return s.ufirst[static_cast<size_t>(x)] < s.ufirst[static_cast<size_t>(y)];
    });
    for (int64_t ck = 0; ck < ce - cs; ck++) {
      const int64_t u = s.lorder[static_cast<size_t>(ck)];
      const uint64_t k = s.ukey[static_cast<size_t>(u)];
      const int64_t pi = static_cast<int64_t>(k & 0x1FFFFF) - 1;
      const int64_t pj = (k >> 21) & 0xFF;
      const int64_t pb = (k >> 29) & 7;
      const double cnt = static_cast<double>(s.ucnt[static_cast<size_t>(u)]);
      double score;
      if (pi == -1) {
        score = cnt - covh;
      } else {
        // falcon.c:405: predecessor column's score; untouched columns keep
        // -1 (falcon.c:426 leaves best_score = -1 in them)
        const uint64_t lk = (static_cast<uint64_t>(pi) << 11) |
                            (static_cast<uint64_t>(pj) << 3) |
                            static_cast<uint64_t>(pb);
        const auto it =
            std::lower_bound(s.colkey.begin(), s.colkey.end(), lk);
        double prev = -1.0;
        if (it != s.colkey.end() && *it == lk) {
          const int64_t ci = it - s.colkey.begin();
          if (ci < c) prev = s.colscore[static_cast<size_t>(ci)];
        }
        score = prev + cnt - covh;
      }
      if (score > best_score) {
        best_score = score;
        s.bl_pi[static_cast<size_t>(c)] = static_cast<int32_t>(pi);
        s.bl_pj[static_cast<size_t>(c)] = static_cast<int32_t>(pj);
        s.bl_pb[static_cast<size_t>(c)] = static_cast<int32_t>(pb);
        s.bl_ck[static_cast<size_t>(c)] = static_cast<int32_t>(ck);
        have = true;
      }
    }
    s.colscore[static_cast<size_t>(c)] = best_score;
    s.bl_none[static_cast<size_t>(c)] = have ? 0 : 1;
    if (best_score > g_best_score) {
      g_best_score = best_score;
      g_best_col = c;
    }
  }
  if (g_best_col < 0) return;

  // backtrack (falcon.c:442-500): emit the column's base only when a valid
  // (non-sentinel) predecessor exists, then step to it by key lookup.
  // Reference quirk (falcon.c:456-460): the FIRST emitted base is the best
  // column's best link INDEX read as a base code (4 -> '-' dropped, >4 ->
  // '$', encoded here as code 5).
  int64_t len = 0;
  int64_t cur = g_best_col;
  const int64_t cap = 2 * tlen;
  const int32_t ck0 = s.bl_ck[static_cast<size_t>(g_best_col)];
  int64_t first_bb = ck0 <= 4 ? ck0 : 5;
  bool first = true;
  // step cap: valid tag chains are strictly decreasing in (t_pos, delta),
  // so at most n_cols steps; degenerate inputs (gap-gap columns can
  // self-link) would loop forever — in the Python path too — so bail out
  int64_t steps = 0;
  while (true) {
    if (s.bl_none[static_cast<size_t>(cur)] ||
        s.bl_pi[static_cast<size_t>(cur)] == -1 || len >= cap ||
        ++steps > n_cols + 1)
      break;
    const uint64_t ck = s.colkey[static_cast<size_t>(cur)];
    const int64_t bb = first ? first_bb : static_cast<int64_t>(ck & 7);
    first = false;
    const int64_t tp = static_cast<int64_t>(ck >> 11);
    if (bb != 4) {
      seq[len] = static_cast<uint8_t>(bb);
      low[len] = (tp < tlen && s.cov[static_cast<size_t>(tp)] <= mincov) ? 1 : 0;
      len++;
    }
    const uint64_t lk =
        (static_cast<uint64_t>(s.bl_pi[static_cast<size_t>(cur)]) << 11) |
        (static_cast<uint64_t>(s.bl_pj[static_cast<size_t>(cur)]) << 3) |
        static_cast<uint64_t>(s.bl_pb[static_cast<size_t>(cur)]);
    const auto it = std::lower_bound(s.colkey.begin(), s.colkey.end(), lk);
    if (it == s.colkey.end() || *it != lk) break;
    cur = it - s.colkey.begin();
  }
  std::reverse(seq, seq + len);
  std::reverse(low, low + len);
  *out_len = len;
}

}  // namespace

// Batch over windows: tags = concatenated (N,6) int32 rows, win_off (B+1)
// row offsets, per-window t_len/min_cov.  Consensus codes and the
// low-coverage mask are written at out_off[i] (caller sizes the buffers as
// cumsum(2*t_len)); out_len[i] = emitted length, or -1 when that window
// must take the Python fallback.  Windows run on n_threads workers.
int64_t falcon_cns_batch(const int32_t* tags, const int64_t* win_off,
                         const int64_t* t_len, const int64_t* min_cov,
                         int64_t B, const int64_t* out_off, uint8_t* out_seq,
                         uint8_t* out_low, int64_t* out_len,
                         int32_t n_threads) {
  if (B <= 0) return 0;
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (nt > B) nt = B;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    CnsScratch scratch;
    while (true) {
      const int64_t i = next.fetch_add(1);
      if (i >= B) break;
      cns_one(tags + 6 * win_off[i], win_off[i + 1] - win_off[i], t_len[i],
              min_cov[i], out_seq + out_off[i], out_low + out_off[i],
              out_len + i, scratch);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Mirrored (j,i) twin traces for the built-in overlapper
// (hinge_tpu/overlap/mapper.py overlap_reads/_mirror_all): every canonical
// record's B-grid trace is interpolated along its (A, W) anchor lattice with
// a telescoping correction so displacements sum exactly to the A span.
// One linear two-pointer pass per record replaces the numpy segmented
// searchsorted/interp soup (the overlap stage's single largest host cost).
// ---------------------------------------------------------------------------

extern "C" {

int64_t mirror_traces(const int32_t* a0, const int32_t* a1, const int32_t* b0,
                      const int32_t* b1, const int32_t* rc,
                      const int32_t* tlen, const int64_t* trace_off,
                      const uint16_t* trace, int64_t n, int32_t tspace,
                      const int64_t* m_off,  // [n] uint16 offsets for outputs
                      uint16_t* m_trace, int32_t n_threads) {
  if (n <= 0) return 0;
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::atomic<int64_t> next(0);
  const int64_t kChunk = 1024;
  auto worker = [&]() {
    std::vector<int64_t> Wasc, Aasc, dm;
    while (true) {
      const int64_t c0 = next.fetch_add(kChunk);
      if (c0 >= n) break;
      const int64_t c1 = std::min(c0 + kChunk, n);
      for (int64_t r = c0; r < c1; r++) {
        const int64_t nd = tlen[r] / 2;  // displacement count
        const int64_t A0 = a0[r], A1 = a1[r], B0 = b0[r], B1 = b1[r];
        const uint16_t* tr = trace + trace_off[r];
        // ascending-W anchors (reverse the lattice for rc records)
        Wasc.assign(nd + 1, 0);
        Aasc.assign(nd + 1, 0);
        const int64_t w0 = rc[r] ? B1 : B0;
        const int64_t wend = rc[r] ? B0 : B1;
        const int64_t sign = rc[r] ? -1 : 1;
        int64_t cum = 0;
        for (int64_t k = 0; k <= nd; k++) {
          int64_t W, A;
          if (k == 0) {
            W = w0;
            A = A0;
          } else if (k == nd) {
            W = wend;
            A = A1;
          } else {
            W = w0 + sign * cum;
            A = (A0 / tspace + k) * tspace;
          }
          if (k < nd) cum += tr[2 * k + 1];
          const int64_t dst = rc[r] ? nd - k : k;
          Wasc[dst] = W;
          Aasc[dst] = A;
        }
        // B-grid bounds + interpolation, two-pointer over ascending anchors
        const int64_t nbB =
            std::max((B1 - 1) / tspace - B0 / tspace, (int64_t)0) + 2;
        dm.assign(nbB - 1, 0);
        int64_t jh = 0;
        int64_t prev_bar = 0;
        int64_t dsum = 0;
        for (int64_t j = 0; j < nbB; j++) {
          int64_t bnd;
          if (j == 0)
            bnd = B0;
          else if (j == nbB - 1)
            bnd = B1;
          else
            bnd = (B0 / tspace + j) * tspace;
          while (jh + 1 <= nd && Wasc[jh + 1] <= bnd) jh++;
          double a_at;
          if (jh < nd) {
            const int64_t denom = std::max(Wasc[jh + 1] - Wasc[jh], (int64_t)1);
            const double frac = (double)(bnd - Wasc[jh]) / (double)denom;
            a_at = (double)Aasc[jh] + frac * (double)(Aasc[jh + 1] - Aasc[jh]);
          } else {
            a_at = (double)Aasc[jh];
          }
          const int64_t bar = (int64_t)rint(a_at);  // half-even, == np.round
          if (j > 0) {
            int64_t d = bar - prev_bar;
            if (d < 0) d = -d;
            dm[j - 1] = d;
            dsum += d;
          }
          prev_bar = bar;
        }
        // telescoping fold so displacements sum exactly to the A span
        const int64_t delta = (A1 - A0) - dsum;
        dm[nbB - 2] = std::max((int64_t)0, dm[nbB - 2] + delta);
        uint16_t* out = m_trace + m_off[r];
        for (int64_t j = 0; j < nbB - 1; j++) {
          int64_t v = dm[j];
          if (v > 65534) v = 65534;
          out[2 * j] = 0;
          out[2 * j + 1] = (uint16_t)v;
        }
      }
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Segmented uint16 copy: dst[dst_off[r] .. +len[r]) = src[src_off[r] ..)
// — the record-interleave step of overlap_reads, minus the numpy
// repeat/arange temporaries.
int64_t scatter_copy_u16(const uint16_t* src, const int64_t* src_off,
                         const int64_t* lens, uint16_t* dst,
                         const int64_t* dst_off, int64_t n) {
  for (int64_t r = 0; r < n; r++) {
    if (lens[r] > 0)
      memcpy(dst + dst_off[r], src + src_off[r],
             (size_t)lens[r] * sizeof(uint16_t));
  }
  return 0;
}

}  // extern "C"
