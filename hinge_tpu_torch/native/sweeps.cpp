// Copied from hinge_tpu/native/sweeps.cpp, unchanged.
//
// Sequential host sweeps that are order-dependent by construction and so
// cannot be expressed as device tensor ops.  Each replicates a reference
// scalar loop exactly; the Python callers keep a numpy fallback.
//
// containment_sweep: the maximal-stage contained-read removal
// (reference: src/maximal/maximal.cpp:787-800 — reads processed in
// ascending id order; a read is contained when any of its BCOVERA top
// matches points at a STILL-ACTIVE containing read, where earlier reads may
// already have been deactivated by their own containment).
#include <cstdint>

// trim_overlaps_batch: LOverlap::trim_overlap over a candidate batch
// (reference: src/lib/LAInterface.cpp:4552-4683).  Walks each overlap's
// trace-point lattice directly from the .las trace bytes — one pass, no
// materialized prefix-sum/point-index arrays — and reproduces the
// ops/classify.py lattice kernel bit-for-bit (cross-pinned by
// tests/test_classify_ops.py): point k has
//   A_k = k==0 ? a_start : k==npairs ? a_end : (a_start/tspace + k)*tspace
//   W_k = k==npairs ? wend : k==0 ? w0 : w0 + sign*cumdisp   (note the
//   k==npairs test outranks k==0 when npairs==0, matching the kernel's
//   where-nesting)
// first start-valid point and last end-valid point become the effective
// match span; active = first_start_k < max(last_end_k, 0).
#include <cstring>

extern "C" int64_t trim_overlaps_batch(
    const int32_t* a_start, const int32_t* a_end,
    const int32_t* b_start, const int32_t* b_end, const int32_t* rc,
    const int32_t* eas, const int32_t* eae,
    const int32_t* ebs, const int32_t* ebe,
    const int32_t* tlen, const int64_t* trace_off, const uint16_t* trace,
    int64_t n, int32_t tspace,
    int32_t* eams, int32_t* eame, int32_t* ebms, int32_t* ebme,
    uint8_t* active)
{
    for (int64_t i = 0; i < n; ++i) {
        const int32_t np_ = tlen[i] / 2;
        const int32_t npts = np_ + 1;
        const int32_t a0 = a_start[i], a1 = a_end[i];
        const int32_t rci = rc[i];
        const int32_t w0 = rci ? b_end[i] : b_start[i];
        const int32_t wend = rci ? b_start[i] : b_end[i];
        const int32_t sgn = 1 - 2 * rci;
        const int32_t EAS = eas[i], EAE = eae[i];
        const int32_t EBS = ebs[i], EBE = ebe[i];
        const uint16_t* tr = trace + trace_off[i];
        const int32_t abase = (a0 / tspace) * tspace;
        int32_t first_k = npts, last_k = -1;
        int32_t sA = 0, sW = 0, eA = 0, eW = 0;
        int64_t cum = 0;
        for (int32_t k = 0; k < npts; ++k) {
            int32_t A, W;
            if (k > 0) cum += tr[2 * (k - 1) + 1];
            if (k == np_) {  // outranks k==0 for W when npairs==0
                A = (k == 0) ? a0 : a1;
                W = wend;
            } else if (k == 0) {
                A = a0;
                W = w0;
            } else {
                A = abase + k * tspace;
                W = w0 + sgn * (int32_t)cum;
            }
            const bool s_ok = (A >= EAS) && (rci ? (W <= EBE) : (W >= EBS));
            const bool e_ok = (A <= EAE) && (rci ? (W >= EBS) : (W <= EBE));
            if (s_ok && first_k == npts) { first_k = k; sA = A; sW = W; }
            if (e_ok) { last_k = k; eA = A; eW = W; }
        }
        const bool found_s = first_k < npts;
        const bool found_e = last_k >= 0;
        const int32_t eidx = found_e ? last_k : 0;
        eams[i] = found_s ? sA : a0;
        eame[i] = found_e ? eA : a1;
        if (rci) {
            ebms[i] = found_e ? eW : b_start[i];
            ebme[i] = found_s ? sW : b_end[i];
        } else {
            ebms[i] = found_s ? sW : b_start[i];
            ebme[i] = found_e ? eW : b_end[i];
        }
        active[i] = first_k < eidx ? 1 : 0;
    }
    return 0;
}

// format_coverage_lines: the X.coverage.txt body (filter.cpp:599-602 —
// "read <i> <pos>,<cov> <pos>,<cov> ...\n" per read).  Formatting 3.5M
// cells through Python f-strings cost ~2s of the filter stage; one
// snprintf pass here is ~50ms.  Returns bytes written, or -1 when cap is
// too small (caller retries with a larger buffer).
#include <cstdio>

extern "C" int64_t format_coverage_lines(
    const int32_t* cov, const int32_t* ne, int64_t n_reads, int64_t nb,
    int32_t reso, int64_t r_begin, char* out, int64_t cap)
{
    int64_t w = 0;
    for (int64_t i = 0; i < n_reads; ++i) {
        if (cap - w < 32) return -1;
        w += snprintf(out + w, (size_t)(cap - w), "read %lld ",
                      (long long)(r_begin + i));
        const int64_t n = ne[i] < nb ? ne[i] : nb;
        const int32_t* row = cov + i * nb;
        for (int64_t j = 0; j < n; ++j) {
            if (cap - w < 32) return -1;
            w += snprintf(out + w, (size_t)(cap - w), "%lld,%d ",
                          (long long)(j * reso), row[j]);
        }
        if (cap - w < 2) return -1;
        out[w++] = '\n';
    }
    return w;
}

// falcon_tags_batch: get_align_tags over a batch of aligned row pairs
// (reference: falcon.c:69-130) — one scalar pass per row, emitting int32
// (t_pos, delta, p_t_pos, p_delta, p_q_base, q_base) tag tuples with the
// exact emission filter (j+t_offset >= 0 && jj < 255 && p_jj < 255) and
// predecessor chaining.  sentinel=1 prepends the virtual 'T'/'T' column
// draft.cpp:652-659 adds before tagging.  Bit-identical to the Python
// scalar oracle (_get_align_tags_scalar), which tests cross-pin.
extern "C" int64_t falcon_tags_batch(
    const uint8_t* q, const uint8_t* t, const int64_t* row_off,
    const int64_t* t_offsets, int64_t n_rows, int32_t sentinel,
    int32_t* out, int64_t* out_cnt)
{
    const uint8_t GAP = 4;
    int64_t w = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t o = row_off[r];
        const int64_t L = row_off[r + 1] - o;
        const int64_t toff = t_offsets[r];
        int64_t j = -1, jj = 0, p_j = -1, p_jj = 0;
        int32_t p_qb = 5;
        int64_t n = 0;
        for (int64_t k = sentinel ? -1 : 0; k < L; ++k) {
            const uint8_t qb = (k < 0) ? 3 : q[o + k];
            const uint8_t tb = (k < 0) ? 3 : t[o + k];
            if (qb != GAP) jj++;
            if (tb != GAP) { j++; jj = 0; }
            if (j + toff >= 0 && jj < 255 && p_jj < 255) {
                int32_t* row = out + 6 * (w + n);
                row[0] = (int32_t)(j + toff);
                row[1] = (int32_t)jj;
                row[2] = (int32_t)(p_j + toff);
                row[3] = (int32_t)p_jj;
                row[4] = p_qb;
                row[5] = qb;
                p_j = j;
                p_jj = jj;
                p_qb = qb;
                n++;
            }
        }
        out_cnt[r] = n;
        w += n;
    }
    return w;
}

// consensus_vote_batch: the consensus column-vote accumulation
// (reference: src/consensus/consensus.cpp:162-230 walk + chop_end :28-45).
// One scalar pass per alignment row over its columns; votes land directly
// in the caller's int64 tables.  Semantically identical to the vectorized
// numpy `_vote_tallies` (stages/consensus.py) which remains the oracle the
// suite pins; this path exists because the numpy version's cumsum chain
// costs ~16s at the 4.6Mb scale vs <1s here.
extern "C" int64_t consensus_vote_batch(
    const uint8_t* flat_a,    // alignment A rows, concatenated (GAP == 4)
    const uint8_t* flat_b,    // alignment B rows, same layout
    const int64_t* seg_off,   // [n_segs+1] row offsets into flat_a/flat_b
    const int64_t* pos0,      // [n_segs] contig start per row
    int64_t n_segs,
    int64_t alen,
    int32_t chop,
    int64_t* scores,          // [alen*5]
    int64_t* cov,             // [alen]
    int64_t* ins_score,       // [alen]
    int64_t* ins_scores)      // [alen*5]
{
    const uint8_t GAP = 4;
    for (int64_t s = 0; s < n_segs; ++s) {
        const int64_t o = seg_off[s];
        const int64_t n = seg_off[s + 1] - o;
        const uint8_t* a = flat_a + o;
        const uint8_t* b = flat_b + o;
        int64_t start = 0, end = n, offset = 0;
        if (n >= 2 * (int64_t)chop + 10) {
            start = chop;
            while (start < n && a[start] == GAP) ++start;
            for (int64_t k = 0; k < start; ++k) offset += (a[k] != GAP);
            end = n - chop;
        }
        int64_t pos = pos0[s] + offset;
        for (int64_t k = start; k < end; ++k) {
            const uint8_t ab = a[k];
            if (ab != GAP) {
                if (pos < alen) {
                    scores[pos * 5 + b[k]]++;
                    cov[pos]++;
                }
                ++pos;
            } else if (b[k] != GAP && pos < alen) {
                ins_score[pos]++;
                ins_scores[pos * 5 + b[k]]++;
            }
        }
    }
    return 0;
}

extern "C" int64_t containment_sweep(
    const int32_t* a_ids,        // candidate rows, sorted ascending by a_id
    const int32_t* b_ids,        // (stable within a group = emission order)
    const uint8_t* is_bcovera,   // match_type == BCOVERA per row
    int64_t n,
    uint8_t* active,             // [n_reads] in-out; updated in place
    int32_t* out_pairs)          // [2*max_pairs] (read, containing) pairs
{
    int64_t n_out = 0;
    int32_t last_i = -1;
    bool contained_flag = false;
    int32_t containing = -1;
    for (int64_t q = 0; q < n; ++q) {
        int32_t i = a_ids[q];
        if (i != last_i) {
            if (last_i >= 0 && contained_flag && active[last_i]) {
                active[last_i] = 0;
                out_pairs[2 * n_out] = last_i;
                out_pairs[2 * n_out + 1] = containing;
                ++n_out;
            }
            last_i = i;
            contained_flag = false;
            containing = -1;
        }
        if (!active[i]) continue;
        if (is_bcovera[q]) {
            // the reference records the containing read regardless of its
            // activity; only the contained FLAG requires an active B
            containing = b_ids[q];
            if (active[containing]) contained_flag = true;
        }
    }
    if (last_i >= 0 && contained_flag && active[last_i]) {
        active[last_i] = 0;
        out_pairs[2 * n_out] = last_i;
        out_pairs[2 * n_out + 1] = containing;
        ++n_out;
    }
    return n_out;
}
