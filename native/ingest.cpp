// Host-side ingest kernels for the DNA-storage decoding pipeline.
//
// The reference delegated its hot loops to native executables (ldpc.exe,
// MUSCLE.exe, rs_dec.exe); in this framework the device-side compute moved
// to accelerator kernels, and this library is the native half that remains on the
// host: per-cluster LLR vote counting over raw read buffers and batched
// Levenshtein edit distance for the cluster pre-filter
// (ex_decoder/decoder.py:163-324 counting rules; def_func.py:10-26 DP).
// Exposed via a C ABI for ctypes; the Python layer keeps a pure-numpy
// fallback with identical semantics.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

extern "C" {

// Bit value of payload byte: A->0/0, C->0/1, G->1/0, T->1/1, other->2/2.
// (def_func.py:97-117). hi = bit 2k, lo = bit 2k+1.
static inline void base_bits(uint8_t b, int* hi, int* lo) {
    switch (b) {
        case 'A': *hi = 0; *lo = 0; break;
        case 'C': *hi = 0; *lo = 1; break;
        case 'G': *hi = 1; *lo = 0; break;
        case 'T': *hi = 1; *lo = 1; break;
        default:  *hi = 2; *lo = 2; break;
    }
}

// Count per-bit votes for one "countable" cluster (all reads exactly 136nt
// with >1 read, or a single read >= 136nt) and write its 272 LLRs.
// Implements the counting rules of decoder.py:266-324: '0' votes zero,
// anything else (including gap symbol 2) votes one; bit 271 excludes
// reads with quality < 53 and applies the literal two-vote quality rule
// (dead +/-2 branches preserved).
static void count_cluster(const uint8_t* bytes, const int64_t* offs,
                          const int32_t* lens, const int64_t* quals,
                          int64_t lo, int64_t hi, double mag, double* out272) {
    int c0[272] = {0}, c1[272] = {0};
    int c0_last = 0, c1_last = 0;
    long q0_last = 0, q1_last = 0;
    for (int64_t r = lo; r < hi; ++r) {
        const uint8_t* s = bytes + offs[r];
        const int L = lens[r] < 136 ? lens[r] : 136;
        for (int k = 0; k < L; ++k) {
            int hib, lob;
            base_bits(s[k], &hib, &lob);
            int i0 = 2 * k, i1 = 2 * k + 1;
            if (i0 < 271) { if (hib == 0) c0[i0]++; else c1[i0]++; }
            if (i1 < 271) { if (lob == 0) c0[i1]++; else c1[i1]++; }
            // bit 271 handled below with the quality filter
            if (i1 == 271 || i0 == 271) {
                int v = (i1 == 271) ? lob : hib;
                if (quals[r] >= 53) {
                    if (v == 0) { c0_last++; q0_last += quals[r]; }
                    else        { c1_last++; q1_last += quals[r]; }
                }
            }
        }
    }
    for (int i = 0; i < 271; ++i) out272[i] = (c0[i] - c1[i]) * mag;
    if (c0_last == 1 && c1_last == 1) {
        if (q0_last < 53 && q1_last >= 63)       out272[271] = -2 * mag;  // dead
        else if (q0_last >= 63 && q1_last < 53)  out272[271] = 2 * mag;   // dead
        else                                     out272[271] = 0.0;
    } else {
        out272[271] = (c0_last - c1_last) * mag;
    }
}

// Process all clusters of a trial that don't need MSA.
//   reads sorted by strand; cluster c spans [starts[c], ends[c]).
//   status[c]: 0 = handled here, 1 = needs the Python/MSA path.
// Handled cases: multi-read all-136; single read >= 136; single read < 136
// (bit-271-only rule, decoder.py:237-261).
void count_trial_llrs(const uint8_t* bytes, const int64_t* offs,
                      const int32_t* lens, const int64_t* quals,
                      const int64_t* starts, const int64_t* ends,
                      const int32_t* strand_of_cluster, int64_t n_clusters,
                      double mag, double* llr_out /* [18432*272] */,
                      int32_t* status) {
    for (int64_t c = 0; c < n_clusters; ++c) {
        int64_t lo = starts[c], hi = ends[c];
        int64_t k = hi - lo;
        double* out = llr_out + (int64_t)strand_of_cluster[c] * 272;
        if (k == 1) {
            if (lens[lo] < 136) {
                // single short read: bit 271 from the read's last bit if q>63
                std::memset(out, 0, 272 * sizeof(double));
                if (quals[lo] > 63 && lens[lo] > 0) {
                    int hib, lob;
                    base_bits(bytes[offs[lo] + lens[lo] - 1], &hib, &lob);
                    out[271] = (lob == 0) ? mag : -mag;
                }
                status[c] = 0;
            } else {
                count_cluster(bytes, offs, lens, quals, lo, hi, mag, out);
                status[c] = 0;
            }
            continue;
        }
        bool all136 = true;
        for (int64_t r = lo; r < hi; ++r)
            if (lens[r] != 136) { all136 = false; break; }
        if (all136) {
            count_cluster(bytes, offs, lens, quals, lo, hi, mag, out);
            status[c] = 0;
        } else {
            status[c] = 1;  // mixed-length: edit filter + MSA in Python/device
        }
    }
}

// Batched exact Levenshtein distance (unit costs), one row-DP per pair.
void edit_distance_batch(const uint8_t* bytes, const int64_t* offs,
                         const int32_t* lens, const int32_t* pa,
                         const int32_t* pb, int64_t n_pairs, int32_t* out) {
    std::vector<int32_t> prev, cur;
    for (int64_t p = 0; p < n_pairs; ++p) {
        const uint8_t* A = bytes + offs[pa[p]];
        const uint8_t* B = bytes + offs[pb[p]];
        const int la = lens[pa[p]], lb = lens[pb[p]];
        prev.assign(lb + 1, 0);
        cur.assign(lb + 1, 0);
        for (int j = 0; j <= lb; ++j) prev[j] = j;
        for (int i = 1; i <= la; ++i) {
            cur[0] = i;
            const uint8_t a = A[i - 1];
            for (int j = 1; j <= lb; ++j) {
                int sub = prev[j - 1] + (a != B[j - 1]);
                int del = prev[j] + 1;
                int ins = cur[j - 1] + 1;
                cur[j] = std::min(sub, std::min(del, ins));
            }
            std::swap(prev, cur);
        }
        out[p] = prev[lb];
    }
}

// Paired-end overlap scoring (pipeline/ingest.py merge_pairs hot loop):
// for each pair, try every overlap length o in [min_o, min(l1,l2)] of
// R1's suffix vs rc(R2)'s prefix; keep the lowest mismatch density
// (ties -> longer overlap). 'N' positions are uninformative. m1/m2 are
// [n, L] right-padded byte matrices (m2 already reverse-complemented).
void merge_overlap_batch(const uint8_t* m1, const uint8_t* m2,
                         const int64_t* l1, const int64_t* l2,
                         int64_t n, int64_t L, int32_t min_o,
                         int64_t* best_o, int64_t* best_mm) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* a_row = m1 + i * L;
        const uint8_t* b_row = m2 + i * L;
        const int64_t max_o = l1[i] < l2[i] ? l1[i] : l2[i];
        double best_den = 1e300;
        int64_t bo = 0, bm = 0;
        for (int64_t o = min_o; o <= max_o; ++o) {
            const uint8_t* a = a_row + (l1[i] - o);
            int64_t mm = 0;
            for (int64_t p = 0; p < o; ++p) {
                const uint8_t x = a[p], y = b_row[p];
                mm += (x != y) & (x != 'N') & (y != 'N');
            }
            const double den = (double)mm / (double)o;
            // same tolerance rule as the numpy path: strictly better, or
            // within 1e-12 (tie) -> the later (longer) overlap wins
            if (den < best_den - 1e-12 || (den <= best_den + 1e-12 && den >= best_den - 1e-12)) {
                best_den = den;
                bo = o;
                bm = mm;
            }
        }
        best_o[i] = bo;
        best_mm[i] = bm;
    }
}

// Maximum-expected-accuracy alignment DP over a posterior matrix
// (MUSCLE calcalnflat.cpp / tracebackflat.cpp): score recurrence
// best(diag + post, up, left) with tie preference B >= X >= Y (best3.h),
// traceback path written as 'B'/'X'/'Y' chars (caller allocates
// LX+LY chars; *path_len receives the actual length). tb_buf must hold
// (LX+1)*(LY+1) bytes of scratch.
void mea_align(const float* post, int32_t LX, int32_t LY, char* tb_buf,
               char* path_out, int32_t* path_len, float* score_out) {
    const int W = LY + 1;
    std::vector<float> prev(W), cur(W);
    for (int j = 0; j <= LY; ++j) { prev[j] = 0.0f; tb_buf[j] = 'Y'; }
    for (int i = 1; i <= LX; ++i) {
        cur[0] = 0.0f;
        tb_buf[i * W] = 'X';
        const float* prow = post + (int64_t)(i - 1) * LY;
        for (int j = 1; j <= LY; ++j) {
            float B = prev[j - 1] + prow[j - 1];
            float X = prev[j];
            float Y = cur[j - 1];
            float best;
            char c;
            if (B >= X) {
                if (B >= Y) { best = B; c = 'B'; }
                else        { best = Y; c = 'Y'; }
            } else if (X >= Y) { best = X; c = 'X'; }
            else               { best = Y; c = 'Y'; }
            cur[j] = best;
            tb_buf[i * W + j] = c;
        }
        std::swap(prev, cur);
    }
    *score_out = prev[LY];
    int i = LX, j = LY, n = 0;
    char* rev = path_out;
    while (i > 0 || j > 0) {
        char c = tb_buf[i * W + j];
        rev[n++] = c;
        if (c == 'B') { --i; --j; }
        else if (c == 'X') --i;
        else --j;
    }
    for (int k = 0; k < n / 2; ++k) std::swap(rev[k], rev[n - 1 - k]);
    *path_len = n;
}

// Score-only variant (CalcAlnScoreFlat) for EA distances.
void mea_score(const float* post, int32_t LX, int32_t LY, float* score_out) {
    const int W = LY + 1;
    std::vector<float> prev(W, 0.0f), cur(W, 0.0f);
    for (int i = 1; i <= LX; ++i) {
        cur[0] = 0.0f;
        const float* prow = post + (int64_t)(i - 1) * LY;
        for (int j = 1; j <= LY; ++j) {
            float B = prev[j - 1] + prow[j - 1];
            float X = prev[j];
            float Y = cur[j - 1];
            cur[j] = B >= X ? (B >= Y ? B : Y) : (X >= Y ? X : Y);
        }
        std::swap(prev, cur);
    }
    *score_out = prev[LY];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Progressive alignment + iterative refinement for one cluster
// (MUSCLE MPCFlat::ProgressiveAlign / Refine, progalnflat.cpp:41-100,
// refineflat.cpp:4-31), operating on precomputed (consistency-transformed)
// pair posteriors. Bit-compatible with the Python path in
// dna_ldpc_tpu/ops/msa/align.py: same f32 accumulation order in the
// profile-profile posterior, same MEA tie preference (B >= X >= Y), same
// convergence rule. Refine bipartition masks are drawn by the CALLER
// (numpy Generator parity) and passed in with all-same masks removed.
// ---------------------------------------------------------------------------

namespace msa {

static const uint8_t GAPC = (uint8_t)'-';

struct Profile {
    std::vector<std::vector<uint8_t>> rows;   // aligned bytes (with gaps)
    std::vector<int> ids;                     // input ordinal per row
};

static void mea_path(const float* post, int LX, int LY, std::string& path) {
    const int W = LY + 1;
    std::vector<char> tb((size_t)(LX + 1) * W);
    std::vector<float> prev(W), cur(W);
    for (int j = 0; j <= LY; ++j) { prev[j] = 0.0f; tb[j] = 'Y'; }
    for (int i = 1; i <= LX; ++i) {
        cur[0] = 0.0f;
        tb[(size_t)i * W] = 'X';
        const float* prow = post + (int64_t)(i - 1) * LY;
        for (int j = 1; j <= LY; ++j) {
            float B = prev[j - 1] + prow[j - 1];
            float X = prev[j];
            float Y = cur[j - 1];
            float best; char c;
            if (B >= X) { if (B >= Y) { best = B; c = 'B'; } else { best = Y; c = 'Y'; } }
            else if (X >= Y) { best = X; c = 'X'; }
            else             { best = Y; c = 'Y'; }
            cur[j] = best;
            tb[(size_t)i * W + j] = c;
        }
        std::swap(prev, cur);
    }
    path.clear();
    int i = LX, j = LY;
    while (i > 0 || j > 0) {
        char c = tb[(size_t)i * W + j];
        path.push_back(c);
        if (c == 'B') { --i; --j; }
        else if (c == 'X') --i;
        else --j;
    }
    std::reverse(path.begin(), path.end());
}

struct PairPosts {
    const float* buf;
    const int64_t* off;
    const int32_t* rows;
    const int32_t* cols;
    int n;
    // pair (a < b) -> flat index in cluster_pairs order
    int idx(int a, int b) const { return a * n - a * (a + 1) / 2 + (b - a - 1); }
};

// Top-k sparse pair posteriors (the device transport form): per pair,
// rows[pi] rows of K slots each, vals f32 + 1-based uint8 column indices
// with 0 marking pruned slots. Each (row, surviving col) cell hits a
// DISTINCT accumulator in BuildPost (cols1/cols2 are strictly
// increasing), so sparse accumulation is bit-identical to the dense
// loop — the only order that matters, the (r1, r2) profile-row loops,
// is unchanged.
struct SparsePairPosts {
    const float* vals;
    const uint8_t* idx;
    const int64_t* off;      // per pair, in ELEMENTS (rows[pi] * K)
    const int32_t* rows;
    int K;
    int n;
    int pidx(int a, int b) const { return a * n - a * (a + 1) / 2 + (b - a - 1); }
};

static void pos_to_col(const std::vector<uint8_t>& row, std::vector<int>& out) {
    out.clear();
    for (int c = 0; c < (int)row.size(); ++c)
        if (row[c] != GAPC) out.push_back(c);
}

// MEA path over a computed profile posterior + gap insertion (the tail
// of AlignAlns, shared by the dense and sparse BuildPost variants)
static Profile merge_with_post(const Profile& p1, const Profile& p2,
                               const std::vector<float>& post) {
    const int c1 = (int)p1.rows[0].size();
    const int c2 = (int)p2.rows[0].size();
    std::string path;
    mea_path(post.data(), c1, c2, path);

    Profile out;
    out.ids = p1.ids;
    out.ids.insert(out.ids.end(), p2.ids.begin(), p2.ids.end());
    out.rows.reserve(out.ids.size());
    for (size_t r = 0; r < p1.rows.size(); ++r) {
        std::vector<uint8_t> nr(path.size());
        size_t p = 0;
        for (size_t k = 0; k < path.size(); ++k)
            nr[k] = (path[k] == 'B' || path[k] == 'X') ? p1.rows[r][p++] : GAPC;
        out.rows.push_back(std::move(nr));
    }
    for (size_t r = 0; r < p2.rows.size(); ++r) {
        std::vector<uint8_t> nr(path.size());
        size_t p = 0;
        for (size_t k = 0; k < path.size(); ++k)
            nr[k] = (path[k] == 'B' || path[k] == 'Y') ? p2.rows[r][p++] : GAPC;
        out.rows.push_back(std::move(nr));
    }
    return out;
}

// profile-profile posterior + MEA + gap insertion (AlignAlns/BuildPost)
static Profile align_profiles(const Profile& p1, const Profile& p2,
                              const PairPosts& pp) {
    const int c1 = (int)p1.rows[0].size();
    const int c2 = (int)p2.rows[0].size();
    std::vector<float> post((size_t)c1 * c2, 0.0f);
    std::vector<int> cols1, cols2;
    for (size_t r1 = 0; r1 < p1.rows.size(); ++r1) {
        int s1 = p1.ids[r1];
        pos_to_col(p1.rows[r1], cols1);
        for (size_t r2 = 0; r2 < p2.rows.size(); ++r2) {
            int s2 = p2.ids[r2];
            pos_to_col(p2.rows[r2], cols2);
            if (s1 < s2) {
                int pi = pp.idx(s1, s2);
                const float* P = pp.buf + pp.off[pi];
                int pc = pp.cols[pi];
                for (size_t a = 0; a < cols1.size(); ++a) {
                    float* dst = post.data() + (size_t)cols1[a] * c2;
                    const float* srow = P + (int64_t)a * pc;
                    for (size_t b = 0; b < cols2.size(); ++b)
                        dst[cols2[b]] += srow[b];
                }
            } else {
                int pi = pp.idx(s2, s1);
                const float* P = pp.buf + pp.off[pi];
                int pc = pp.cols[pi];
                for (size_t a = 0; a < cols1.size(); ++a) {
                    float* dst = post.data() + (size_t)cols1[a] * c2;
                    for (size_t b = 0; b < cols2.size(); ++b)
                        dst[cols2[b]] += P[(int64_t)b * pc + a];
                }
            }
        }
    }
    return merge_with_post(p1, p2, post);
}

// sparse-transport variant of BuildPost: same accumulation cells, same
// (r1, r2) loop order, entries iterated from the top-k slots
static Profile align_profiles_sp(const Profile& p1, const Profile& p2,
                                 const SparsePairPosts& spp) {
    const int c1 = (int)p1.rows[0].size();
    const int c2 = (int)p2.rows[0].size();
    std::vector<float> post((size_t)c1 * c2, 0.0f);
    std::vector<int> cols1, cols2;
    const int K = spp.K;
    for (size_t r1 = 0; r1 < p1.rows.size(); ++r1) {
        int s1 = p1.ids[r1];
        pos_to_col(p1.rows[r1], cols1);
        for (size_t r2 = 0; r2 < p2.rows.size(); ++r2) {
            int s2 = p2.ids[r2];
            pos_to_col(p2.rows[r2], cols2);
            if (s1 < s2) {
                int pi = spp.pidx(s1, s2);
                const float* V = spp.vals + spp.off[pi];
                const uint8_t* I = spp.idx + spp.off[pi];
                for (size_t a = 0; a < cols1.size(); ++a) {
                    float* dst = post.data() + (size_t)cols1[a] * c2;
                    const float* vr = V + (int64_t)a * K;
                    const uint8_t* ir = I + (int64_t)a * K;
                    for (int k = 0; k < K; ++k) {
                        int b = (int)ir[k] - 1;  // 1-based, 0 = pruned
                        if (b >= 0 && b < (int)cols2.size())
                            dst[cols2[b]] += vr[k];
                    }
                }
            } else {
                int pi = spp.pidx(s2, s1);
                const float* V = spp.vals + spp.off[pi];
                const uint8_t* I = spp.idx + spp.off[pi];
                // transposed: P's rows are s2 positions (b side), its
                // sparse columns are s1 positions (a side)
                for (size_t b = 0; b < cols2.size(); ++b) {
                    const float* vr = V + (int64_t)b * K;
                    const uint8_t* ir = I + (int64_t)b * K;
                    int dc = cols2[b];
                    for (int k = 0; k < K; ++k) {
                        int a = (int)ir[k] - 1;
                        if (a >= 0 && a < (int)cols1.size())
                            post[(size_t)cols1[a] * c2 + dc] += vr[k];
                    }
                }
            }
        }
    }
    return merge_with_post(p1, p2, post);
}

// subset rows by id set and drop all-gap columns (MultiSequence::Project).
// Rows are emitted in ASCENDING seq-id order — the Python path's
// _refine_split builds its sub-profiles from the ascending bipartition
// id list, and the f32 accumulation order downstream must match.
static Profile project(const Profile& p, const std::vector<char>& take_id) {
    Profile out;
    std::vector<std::pair<int, size_t>> order;
    for (size_t r = 0; r < p.rows.size(); ++r)
        if (take_id[p.ids[r]]) order.push_back({p.ids[r], r});
    std::sort(order.begin(), order.end());
    std::vector<size_t> keep_rows;
    for (size_t k = 0; k < order.size(); ++k) {
        keep_rows.push_back(order[k].second);
        out.ids.push_back(order[k].first);
    }
    const size_t ncol = p.rows[0].size();
    std::vector<char> keep_col(ncol, 0);
    size_t kept = 0;
    for (size_t c = 0; c < ncol; ++c) {
        for (size_t k = 0; k < keep_rows.size(); ++k)
            if (p.rows[keep_rows[k]][c] != GAPC) { keep_col[c] = 1; ++kept; break; }
    }
    for (size_t k = 0; k < keep_rows.size(); ++k) {
        const std::vector<uint8_t>& src = p.rows[keep_rows[k]];
        std::vector<uint8_t> nr; nr.reserve(kept);
        for (size_t c = 0; c < ncol; ++c) if (keep_col[c]) nr.push_back(src[c]);
        out.rows.push_back(std::move(nr));
    }
    return out;
}

}  // namespace msa

extern "C" {

static void run_progressive_refine(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* seq_len,
    int32_t n,
    const int32_t* joins,
    const msa::PairPosts* pp, const msa::SparsePairPosts* spp,
    const uint8_t* masks, int32_t n_masks, int32_t converge_after,
    uint8_t* out_buf, int32_t out_cap, int32_t* out_cols)
{
    using msa::Profile;
    auto merge = [&](const Profile& a, const Profile& b) {
        return spp ? msa::align_profiles_sp(a, b, *spp)
                   : msa::align_profiles(a, b, *pp);
    };

    std::vector<Profile> nodes(2 * n - 1);
    for (int i = 0; i < n; ++i) {
        nodes[i].ids.push_back(i);
        nodes[i].rows.emplace_back(seq_buf + seq_off[i], seq_buf + seq_off[i] + seq_len[i]);
    }
    for (int k = 0; k < n - 1; ++k) {
        int a = joins[2 * k], b = joins[2 * k + 1];
        nodes[n + k] = merge(nodes[a], nodes[b]);
        nodes[a] = Profile();  // release
        nodes[b] = Profile();
    }
    Profile final_p = std::move(nodes[2 * n - 2]);

    // iterative refinement over precomputed bipartitions
    int unchanged = 0;
    std::vector<char> take(n);
    for (int it = 0; it < n_masks && unchanged < converge_after; ++it) {
        const uint8_t* m = masks + (size_t)it * n;
        for (int i = 0; i < n; ++i) take[i] = m[i] ? 1 : 0;
        Profile p1 = msa::project(final_p, take);
        for (int i = 0; i < n; ++i) take[i] = !take[i];
        Profile p2 = msa::project(final_p, take);
        Profile next = merge(p1, p2);
        // compare with previous by seq id
        bool same = next.rows[0].size() == final_p.rows[0].size();
        if (same) {
            std::vector<int> row_of(n);
            for (size_t r = 0; r < next.ids.size(); ++r) row_of[next.ids[r]] = (int)r;
            for (size_t r = 0; r < final_p.rows.size() && same; ++r)
                same = final_p.rows[r] == next.rows[row_of[final_p.ids[r]]];
        }
        unchanged = same ? unchanged + 1 : 0;
        final_p = std::move(next);
    }

    const int cols = (int)final_p.rows[0].size();
    *out_cols = cols;
    if (cols > out_cap) { *out_cols = -cols; return; }
    for (size_t r = 0; r < final_p.rows.size(); ++r) {
        std::memcpy(out_buf + (size_t)final_p.ids[r] * out_cap,
                    final_p.rows[r].data(), cols);
    }
}


void msa_progressive_refine(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* seq_len,
    int32_t n,
    const int32_t* joins,                // [(n-1)*2] node ids
    const float* post_buf, const int64_t* post_off,
    const int32_t* post_r, const int32_t* post_c,
    const uint8_t* masks, int32_t n_masks, int32_t converge_after,
    uint8_t* out_buf, int32_t out_cap, int32_t* out_cols)
{
    msa::PairPosts pp{post_buf, post_off, post_r, post_c, (int)n};
    run_progressive_refine(seq_buf, seq_off, seq_len, n, joins, &pp, nullptr,
                           masks, n_masks, converge_after,
                           out_buf, out_cap, out_cols);
}

// sparse-transport entry: pair posteriors arrive in the device top-k
// form (vals f32 + 1-based uint8 column indices, 0 = pruned; row stride
// K) - no host densification at all
void msa_progressive_refine_sp(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* seq_len,
    int32_t n,
    const int32_t* joins,
    const float* sv, const uint8_t* si, const int64_t* post_off,
    const int32_t* post_r, int32_t K,
    const uint8_t* masks, int32_t n_masks, int32_t converge_after,
    uint8_t* out_buf, int32_t out_cap, int32_t* out_cols)
{
    msa::SparsePairPosts spp{sv, si, post_off, post_r, (int)K, (int)n};
    run_progressive_refine(seq_buf, seq_off, seq_len, n, joins, nullptr, &spp,
                           masks, n_masks, converge_after,
                           out_buf, out_cap, out_cols);
}

}  // extern "C"

