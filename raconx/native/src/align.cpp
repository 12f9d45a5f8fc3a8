// Pairwise alignment for the host runtime (the reference's edlib/spoa-engine
// roles, re-implemented from scratch):
//
//  - banded edit-distance NW with adaptive band doubling (exactness check:
//    a banded optimum D <= x cannot be beaten by any path leaving the band,
//    since leaving costs > x). Divide-and-conquer splitting keeps traceback
//    memory bounded for very long overlaps.
//  - full-matrix linear-gap NW (maximize) for layer-vs-backbone alignment.
//
// Tie-breaking is standardized across python/native/device backends:
// DIAG > UP (consume query) > LEFT (consume target).

#include "align.hpp"

#include <algorithm>
#include <climits>
#include <cstring>

namespace rt {

static const int32_t kInf = INT32_MAX / 4;

static inline void push_op(std::vector<OpRun>& ops, int32_t op, int32_t run) {
    if (run <= 0) return;
    if (!ops.empty() && ops.back().op == op) {
        ops.back().run += run;
    } else {
        ops.push_back({op, run});
    }
}

// ---------------------------------------------------------------------- //
// banded edit distance, distance-only; optionally captures the score row at
// query row `capture_i` (band-local, size W) for divide-and-conquer splits.
// Returns the distance for the fixed margin x, or -1 if the band proved
// insufficient (result > x and band not full).
// ---------------------------------------------------------------------- //

struct Band {
    int64_t dlo;  // lowest diagonal j - i in band
    int64_t W;    // band width
};

static Band make_band(int64_t m, int64_t n, int64_t x) {
    int64_t dlo = std::min<int64_t>(0, n - m) - x;
    int64_t dhi = std::max<int64_t>(0, n - m) + x;
    dlo = std::max(dlo, -m);
    dhi = std::min(dhi, n);
    return {dlo, dhi - dlo + 1};
}

// ---------------------------------------------------------------------- //
// Myers bit-parallel banded edit distance (the reference's edlib role,
// vendor/edlib + src/overlap.cpp:205-224 — re-implemented from the published
// algorithm: Myers 1999 block recurrence as formulated by Hyyrö 2003, with a
// block-granular Ukkonen band window). 64 DP cells per ~17 word ops.
//
// Band correctness: cells at the window boundary are seeded with +1/row
// extensions and hin=+1, both of which can only OVERestimate true DP values
// (min-plus DP with inflated boundary stays an upper bound). Any optimal
// path of cost d <= x lies fully inside the make_band(m,n,x) window, and
// every cell on it depends only on cells on such a path, so values along it
// — including the final (m, n) cell whenever d <= x — are exact. The
// acceptance test (d <= x, or the band covers the whole matrix) therefore
// returns exact distances only, and -1 means "band too small, double it",
// exactly like the scalar version it replaces.
// ---------------------------------------------------------------------- //

struct MyersState {
    std::vector<uint64_t> peq;   // n_slots x nb presence masks
    std::vector<uint64_t> PV, MV;
    std::vector<int64_t> score;  // score at the bottom row (64b+64) per block
    int slot[256];
};

// score at row 64b + r + 1 from the block-bottom score at row 64b + 64,
// walking the vertical deltas (PV bit k: +1 between rows 64b+k and 64b+k+1)
static inline int64_t score_up(int64_t bottom, uint64_t PV, uint64_t MV,
                               int64_t r) {
    if (r >= 63) return bottom;
    const uint64_t mask = ~((1ULL << (r + 1)) - 1);
    return bottom - (__builtin_popcountll(PV & mask) -
                     __builtin_popcountll(MV & mask));
}

// one 64-row block column step (Hyyrö's block formulation of Myers);
// returns the horizontal delta out of the block bottom
static inline int advance_block(uint64_t Eq, uint64_t& PV, uint64_t& MV,
                                int hin) {
    const uint64_t Xv = Eq | MV;
    if (hin < 0) Eq |= 1ULL;
    const uint64_t Xh = (((Eq & PV) + PV) ^ PV) | Eq;
    uint64_t Ph = MV | ~(Xh | PV);
    uint64_t Mh = PV & Xh;
    int hout = 0;
    if (Ph >> 63) hout = 1;
    else if (Mh >> 63) hout = -1;
    Ph = (Ph << 1) | (hin > 0 ? 1ULL : 0ULL);
    Mh = (Mh << 1) | (hin < 0 ? 1ULL : 0ULL);
    PV = Mh | ~(Xv | Ph);
    MV = Ph & Xv;
    return hout;
}

// drop-in replacement for banded_distance_fixed (same band layout and
// capture contract), ~30x faster on long inputs
static int64_t myers_distance_fixed(const uint8_t* q, int64_t m,
                                    const uint8_t* t, int64_t n, int64_t x,
                                    int64_t capture_i, int32_t* capture_row,
                                    MyersState& st) {
    Band band = make_band(m, n, x);
    const int64_t W = band.W, dlo = band.dlo;
    const int64_t dhi = dlo + W - 1;
    const int64_t nb = (m + 63) / 64;

    // presence masks for each distinct target byte (raw-byte equality, same
    // semantics as the scalar DP: any two equal bytes match)
    for (int c = 0; c < 256; ++c) st.slot[c] = -1;
    int n_slots = 0;
    for (int64_t j = 0; j < n; ++j) {
        if (st.slot[t[j]] < 0) st.slot[t[j]] = n_slots++;
    }
    st.peq.assign(static_cast<size_t>(n_slots) * nb, 0);
    for (int64_t i = 0; i < m; ++i) {
        const int s = st.slot[q[i]];
        if (s >= 0) {
            st.peq[static_cast<size_t>(s) * nb + (i >> 6)] |=
                1ULL << (i & 63);
        }
    }

    st.PV.assign(nb, ~0ULL);
    st.MV.assign(nb, 0);
    st.score.resize(nb);
    // column 0 exact: H[i][0] = i
    auto init_exact = [&](int64_t b) {
        st.PV[b] = ~0ULL;
        st.MV[b] = 0;
        st.score[b] = 64 * (b + 1);
    };
    // window [fb, lb] of active blocks at the current column
    int64_t fb = 0;
    int64_t lb = std::min<int64_t>(nb - 1, (0 - dlo - 1) >> 6);
    if (lb < 0) lb = 0;  // keep at least one block live
    for (int64_t b = fb; b <= lb; ++b) init_exact(b);

    const int64_t cap_b = capture_i > 0 ? (capture_i - 1) >> 6 : -1;
    const int64_t cap_r = capture_i > 0 ? (capture_i - 1) & 63 : -1;
    if (capture_row && capture_i >= 0) {
        // j = 0 entry if the band covers it (H[i][0] = i)
        const int64_t k0 = 0 - capture_i - dlo;
        if (k0 >= 0 && k0 < W) {
            capture_row[k0] = static_cast<int32_t>(capture_i);
        }
    }

    for (int64_t j = 1; j <= n; ++j) {
        // drop blocks fully above the band top (row j - dhi); hin into the
        // new first block becomes +1 (inflated boundary, see header note)
        while (fb < lb && 64 * (fb + 1) < j - dhi) ++fb;
        const int s = st.slot[t[j - 1]];
        const uint64_t* peq_c =
            s >= 0 ? st.peq.data() + static_cast<size_t>(s) * nb : nullptr;
        int hin = 1;  // row 0 boundary (H[0][j] = j) and dropped-block proxy
        for (int64_t b = fb; b <= lb; ++b) {
            const uint64_t Eq = peq_c ? peq_c[b] : 0;
            const int hout = advance_block(Eq, st.PV[b], st.MV[b], hin);
            st.score[b] += hout;
            hin = hout;
        }
        // activate at most one new block when the band bottom enters it;
        // seed with the current column's +1/row extension (upper bound)
        const int64_t want_lb =
            std::min<int64_t>(nb - 1, (j - dlo - 1) >> 6);
        if (want_lb > lb) {
            ++lb;
            st.PV[lb] = ~0ULL;
            st.MV[lb] = 0;
            st.score[lb] = st.score[lb - 1] + 64;
        }
        if (capture_row && capture_i > 0 && cap_b >= fb && cap_b <= lb) {
            const int64_t k = j - capture_i - dlo;
            if (k >= 0 && k < W) {
                capture_row[k] = static_cast<int32_t>(
                    score_up(st.score[cap_b], st.PV[cap_b], st.MV[cap_b],
                             cap_r));
            }
        }
    }

    const int64_t bm = (m - 1) >> 6;
    if (bm < fb || bm > lb) return -1;
    const int64_t d = score_up(st.score[bm], st.PV[bm], st.MV[bm],
                               (m - 1) & 63);
    const bool full_band = (band.dlo == -m && band.dlo + W - 1 == n);
    if (d > x && !full_band) return -1;
    return d;
}

int64_t edit_distance(const uint8_t* q, int64_t m, const uint8_t* t,
                      int64_t n) {
    if (m == 0) return n;
    if (n == 0) return m;
    MyersState st;
    int64_t x = 64;
    const int64_t drift = m > n ? m - n : n - m;
    while (x <= drift) x *= 2;
    while (true) {
        int64_t d = myers_distance_fixed(q, m, t, n, x, -1, nullptr, st);
        if (d >= 0) return d;
        x *= 2;
    }
}

// ---------------------------------------------------------------------- //
// banded edit alignment with traceback (adaptive band + D&C for memory)
// ---------------------------------------------------------------------- //

// Direct banded fill is the slow path (1 byte-move/cell, scalar DP); with
// WFA handling every subproblem whose distance fits kWfaCap, a small budget
// here just forces one extra (cheap, bit-parallel) split so the children
// land in WFA range instead of burning 50M+ scalar cells.
static const int64_t kMovesBudget = int64_t(8) << 20;  // bytes per call

// direct banded alignment with a byte move matrix; x is trusted (caller
// verified the distance fits)
static void banded_align_direct(const uint8_t* q, int64_t m, const uint8_t* t,
                                int64_t n, int64_t x, std::vector<OpRun>& ops) {
    Band b = make_band(m, n, x);
    const int64_t W = b.W, dlo = b.dlo;
    std::vector<int32_t> prev(W + 2, kInf), cur(W + 2, kInf);
    std::vector<uint8_t> moves(static_cast<size_t>(m + 1) * W, 3);
    for (int64_t k = 0; k < W; ++k) {
        int64_t j = dlo + k;
        prev[k + 1] = (j >= 0 && j <= n) ? static_cast<int32_t>(j) : kInf;
        if (j > 0 && j <= n) moves[k] = 2;  // row 0: all LEFT
    }
    for (int64_t i = 1; i <= m; ++i) {
        const uint8_t qc = q[i - 1];
        const int64_t jlo = std::max<int64_t>(0, i + dlo);
        const int64_t jhi = std::min<int64_t>(n, i + dlo + W - 1);
        std::fill(cur.begin(), cur.end(), kInf);
        uint8_t* mrow = moves.data() + static_cast<size_t>(i) * W;
        for (int64_t j = jlo; j <= jhi; ++j) {
            const int64_t k = j - i - dlo;
            int32_t best;
            uint8_t mv;
            if (j == 0) {
                best = static_cast<int32_t>(i);
                mv = 1;  // UP column
            } else {
                const int32_t diag = prev[k + 1] + (qc == t[j - 1] ? 0 : 1);
                const int32_t up = prev[k + 2] >= kInf ? kInf : prev[k + 2] + 1;
                const int32_t left = cur[k] >= kInf ? kInf : cur[k] + 1;
                best = std::min(diag, std::min(up, left));
                mv = (diag == best) ? 0 : (up == best ? 1 : 2);
            }
            cur[k + 1] = best;
            mrow[k] = mv;
        }
        std::swap(prev, cur);
    }
    // traceback
    std::vector<OpRun> rev;
    int64_t i = m, j = n;
    while (i > 0 || j > 0) {
        const int64_t k = j - i - dlo;
        const uint8_t mv = moves[static_cast<size_t>(i) * W + k];
        if (mv == 0) {
            push_op(rev, OP_MATCH, 1);
            --i;
            --j;
        } else if (mv == 1) {
            push_op(rev, OP_INS, 1);
            --i;
        } else {
            push_op(rev, OP_DEL, 1);
            --j;
        }
    }
    // rev holds runs back-to-front; append reversed
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
        push_op(ops, it->op, it->run);
    }
}

// ---------------------------------------------------------------------- //
// unit-cost wavefront alignment (diagonal-transition / WFA form of the
// Levenshtein DP: furthest-reaching offsets per (score, diagonal) with
// greedy match extension). O(d^2 + matches) instead of O(m * band) — the
// traceback engine of choice once the exact distance is known.
// The traceback is the scalar DP's own (DIAG > UP (INS) > LEFT (DEL) from
// (m, n)), so every backend picks the same path among co-optimal ones.
// Up to kWfaResident bytes every front stays in memory; past that fronts
// are kept at every K-th score (K ~ sqrt(d)) and the ones the traceback
// needs are recomputed a segment at a time: O(d^1.5) memory.
// ---------------------------------------------------------------------- //

// device tiers stop at band 4096, so every distance the device serves is
// far below the cap (~34 MB of fronts per call at the cap)
static const int64_t kWfaCap = int64_t(1) << 14;
static const int64_t kWfaResident = int64_t(16) << 20;  // bytes
static const int32_t kNoOff = INT32_MIN / 2;  // unreachable (offsets >= 0)

// candidates reaching diagonal k at score s (pre-extension), in tie order
static inline int32_t wfa_candidate(const int32_t* prev, int64_t lo,
                                    int64_t hi, int64_t k, int64_t m,
                                    int64_t n) {
    int32_t best = kNoOff;
    if (k >= lo && k <= hi) {  // substitution: (i,j) -> (i+1, j+1)
        const int32_t a = prev[k - lo];
        if (a != kNoOff && a < m && a + k < n && a + 1 > best) best = a + 1;
    }
    if (k + 1 >= lo && k + 1 <= hi) {  // insertion (consume q): k+1 -> k
        const int32_t b = prev[k + 1 - lo];
        if (b != kNoOff && b < m && b + 1 > best) best = b + 1;
    }
    if (k - 1 >= lo && k - 1 <= hi) {  // deletion (consume t): k-1 -> k
        const int32_t c = prev[k - 1 - lo];
        if (c != kNoOff && c + k <= n && c > best) best = c;  // may land on n
    }
    return best;
}

// requires d_cap >= exact distance; returns false if the cap is exceeded
static bool wfa_align(const uint8_t* q, int64_t m, const uint8_t* t,
                      int64_t n, int64_t d_cap, std::vector<OpRun>& ops) {
    if (d_cap > kWfaCap) return false;
    const int64_t kend = n - m;
    // a front is indexed by diagonal k in [-D - 1, D + 1] (at k + D + 1),
    // kNoOff where it does not reach
    const int64_t D = d_cap, width = 2 * D + 3;

    // greedy match extension along diagonal k from offset i (8 bytes/step)
    auto extend = [&](int64_t i, int64_t k) -> int64_t {
        const int64_t ilim = std::min(m, n - k);
        while (i + 8 <= ilim) {
            uint64_t a, b;
            std::memcpy(&a, q + i, 8);
            std::memcpy(&b, t + i + k, 8);
            const uint64_t x = a ^ b;
            if (x) return i + (__builtin_ctzll(x) >> 3);
            i += 8;
        }
        while (i < ilim && q[i] == t[i + k]) ++i;
        return i;
    };
    // front s reaches diagonals [-s, s]; step s + 1 reads one further out,
    // so only [-s - 2, s + 2] of a front is ever written, copied or read
    auto span = [&](int64_t s) {
        return std::make_pair(std::max(-s - 2, -D - 1) + D + 1,
                              std::min(s + 2, D + 1) + D + 2);
    };
    auto copy = [&](int32_t* dst, const int32_t* src, int64_t s) {
        const auto [a, b] = span(s);
        std::memcpy(dst + a, src + a, (b - a) * sizeof(int32_t));
    };
    auto front0 = [&](int32_t* f) {
        const auto [a, b] = span(0);
        std::fill(f + a, f + b, kNoOff);
        f[D + 1] = static_cast<int32_t>(extend(0, 0));
    };
    // front s from front s - 1
    auto step = [&](const int32_t* prev, int32_t* cur, int64_t s) {
        const auto [a, b] = span(s);
        std::fill(cur + a, cur + b, kNoOff);
        const int64_t klo = std::max(-s, -m), khi = std::min(s, n);
        for (int64_t k = klo; k <= khi; ++k) {
            // the fast path takes the 3-way max and accepts it when it
            // cannot have overshot the matrix (raw <= lim implies every
            // candidate was individually valid — see wfa_candidate)
            int32_t raw = prev[k + D + 1] + 1;
            if (prev[k + D + 2] + 1 > raw) raw = prev[k + D + 2] + 1;
            if (prev[k + D] > raw) raw = prev[k + D];
            const int64_t lim = std::min(m, n - k);
            int64_t i = raw;
            if (!(raw >= 0 && raw <= lim)) {
                i = wfa_candidate(prev + D + 2 - s, -(s - 1), s - 1, k, m, n);
                if (i == kNoOff) continue;
            }
            cur[k + D + 1] = static_cast<int32_t>(extend(i, k));
        }
    };
    // segment c holds fronts [c*K, c*K + K] in slots 0..K; checkpoint c is
    // its front c*K. K = d_cap keeps the whole forward pass resident.
    int64_t K = 16;
    while (K * K < d_cap) ++K;
    if ((d_cap + 1) * width * int64_t(sizeof(int32_t)) <= kWfaResident) {
        K = std::max<int64_t>(d_cap, 1);
    }
    thread_local std::vector<int32_t> ckpt, seg;
    ckpt.resize(static_cast<size_t>(d_cap / K + 1) * width);
    seg.resize(static_cast<size_t>(K + 1) * width);
    // buffers past twice the resident budget go back to the heap on return
    struct Trim {
        ~Trim() {
            if ((ckpt.capacity() + seg.capacity()) * sizeof(int32_t) >
                static_cast<size_t>(2 * kWfaResident)) {
                std::vector<int32_t>().swap(ckpt);
                std::vector<int32_t>().swap(seg);
            }
        }
    } trim;
    auto ck = [&](int64_t c) { return ckpt.data() + c * width; };
    auto slot = [&](int64_t u) { return seg.data() + u * width; };

    // forward: fill one segment after another, keeping each one's start
    front0(slot(0));
    copy(ck(0), slot(0), 0);
    int64_t seg_c = 0;
    int64_t d = (kend == 0 && slot(0)[D + 1] == m) ? 0 : -1;
    for (int64_t s = 1; d < 0 && s <= d_cap; ++s) {
        if (s - seg_c * K > K) {  // front s - 1 opens the next segment
            copy(slot(0), slot(K), s - 1);
            ++seg_c;
        }
        int32_t* cur = slot(s - seg_c * K);
        step(cur - width, cur, s);
        if (s % K == 0) copy(ck(s / K), cur, s);
        if (std::abs(kend) <= s && cur[kend + D + 1] == m) d = s;
    }
    if (d < 0) return false;

    // front s from the loaded segment, else recompute its segment from
    // the checkpoint (the last segment of the forward pass is still loaded)
    auto front = [&](int64_t s) -> const int32_t* {
        if (s < seg_c * K || s > seg_c * K + K) {
            const int64_t c = s / K;
            copy(slot(0), ck(c), c * K);
            for (int64_t u = 1; u <= K && c * K + u <= d; ++u) {
                step(slot(u - 1), slot(u), c * K + u);
            }
            seg_c = c;
        }
        return slot(s - seg_c * K);
    };
    // H[i][i + k] <= s  iff  f(s, k) >= i  (H is non-decreasing along a
    // diagonal, and f is the furthest offset on k reached with score s)
    auto reach = [&](int64_t s, int64_t k, int64_t i) {
        if (s < 0 || k < -s || k > s) return false;
        const int32_t f = front(s)[k + D + 1];
        return f != kNoOff && f >= i;
    };

    std::vector<OpRun> rev;
    int64_t i = m, j = n, s = d;  // invariant: H[i][j] == s
    while (i > 0 || j > 0) {
        if (i == 0) {
            push_op(rev, OP_DEL, static_cast<int32_t>(j));
            break;
        }
        if (j == 0) {
            push_op(rev, OP_INS, static_cast<int32_t>(i));
            break;
        }
        if (q[i - 1] == t[j - 1]) {  // a match keeps H: always DIAG
            push_op(rev, OP_MATCH, 1);
            --i;
            --j;
        } else if (reach(s - 1, j - i, i - 1)) {
            push_op(rev, OP_MATCH, 1);  // substitution is CIGAR M
            --i;
            --j;
            --s;
        } else if (reach(s - 1, j - i + 1, i - 1)) {
            push_op(rev, OP_INS, 1);
            --i;
            --s;
        } else {
            push_op(rev, OP_DEL, 1);
            --j;
            --s;
        }
    }
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
        push_op(ops, it->op, it->run);
    }
    return true;
}

// find the column where an optimal path crosses query row `mid` by combining
// forward scores (row mid) with backward scores of the reversed problem;
// also reports the exact sub-distances on each side of the crossing so the
// recursion can shrink each child's band to what that child actually needs
static int64_t split_column(const uint8_t* q, int64_t m, const uint8_t* t,
                            int64_t n, int64_t x, int64_t mid, int64_t* d_left,
                            int64_t* d_right) {
    Band fb = make_band(m, n, x);
    std::vector<int32_t> frow(fb.W, kInf), brow(fb.W, kInf);
    MyersState st;
    myers_distance_fixed(q, m, t, n, x, mid, frow.data(), st);
    std::vector<uint8_t> qr(m), tr(n);
    for (int64_t i = 0; i < m; ++i) qr[i] = q[m - 1 - i];
    for (int64_t j = 0; j < n; ++j) tr[j] = t[n - 1 - j];
    // backward: align qr (rows) vs tr; row (m - mid) of the reverse problem
    // corresponds to query row mid; its column j' = n - j.
    Band bb = make_band(m, n, x);
    myers_distance_fixed(qr.data(), m, tr.data(), n, x, m - mid, brow.data(),
                         st);
    int64_t best_j = -1;
    int64_t best = INT64_MAX;
    for (int64_t k = 0; k < fb.W; ++k) {
        const int64_t j = mid + fb.dlo + k;
        if (j < 0 || j > n) continue;
        const int64_t ir = m - mid;          // reverse row
        const int64_t jr = n - j;            // reverse column
        const int64_t kr = jr - ir - bb.dlo;
        if (kr < 0 || kr >= bb.W) continue;
        if (frow[k] >= kInf || brow[kr] >= kInf) continue;
        const int64_t total = int64_t(frow[k]) + brow[kr];
        if (total < best) {
            best = total;
            best_j = j;
            *d_left = frow[k];
            *d_right = brow[kr];
        }
    }
    return best_j;
}

static void banded_align_rec(const uint8_t* q, int64_t m, const uint8_t* t,
                             int64_t n, int64_t x, std::vector<OpRun>& ops) {
    if (m == 0) {
        push_op(ops, OP_DEL, static_cast<int32_t>(n));
        return;
    }
    if (n == 0) {
        push_op(ops, OP_INS, static_cast<int32_t>(m));
        return;
    }
    Band b = make_band(m, n, x);
    // small problems keep the exact-tie scalar DP (DIAG > UP > LEFT — the
    // cross-backend oracle contract); it is also faster than WFA's setup
    // at this size
    static const int64_t kDirectSmall = int64_t(2) << 20;
    if ((m + 1) * b.W <= kDirectSmall) {
        banded_align_direct(q, m, t, n, x, ops);
        return;
    }
    // x is the exact distance of this subproblem (edit_align verifies the
    // top level; splits report exact child distances) — WFA is O(x^2) and
    // beats the O(m*W) banded fill whenever it fits its memory cap, with
    // the scalar DP's tie-breaking. Only distances past kWfaCap reach the
    // split below, whose crossing choice may tie-break differently.
    if (x <= kWfaCap && wfa_align(q, m, t, n, x, ops)) return;
    if ((m + 1) * b.W <= kMovesBudget) {
        banded_align_direct(q, m, t, n, x, ops);
        return;
    }
    const int64_t mid = m / 2;
    int64_t dl = x, dr = x;
    int64_t jsplit = split_column(q, m, t, n, x, mid, &dl, &dr);
    if (jsplit < 0) {  // should not happen with a verified band; be safe
        banded_align_direct(q, m, t, n, x, ops);
        return;
    }
    // children get bands sized to their EXACT sub-distances (a cost-d path
    // never strays more than d diagonals from its endpoint diagonals), so
    // leaf DP area shrinks as the errors split across the halves
    banded_align_rec(q, mid, t, jsplit, std::max<int64_t>(dl, 1), ops);
    banded_align_rec(q + mid, m - mid, t + jsplit, n - jsplit,
                     std::max<int64_t>(dr, 1), ops);
}

int64_t edit_align(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                   std::vector<OpRun>& ops) {
    ops.clear();
    if (m == 0) {
        push_op(ops, OP_DEL, static_cast<int32_t>(n));
        return n;
    }
    if (n == 0) {
        push_op(ops, OP_INS, static_cast<int32_t>(m));
        return m;
    }
    MyersState st;
    // the band must at least absorb the length difference; starting the
    // doubling there skips the guaranteed-futile small-band passes
    int64_t x = 64;
    const int64_t drift = m > n ? m - n : n - m;
    while (x <= drift) x *= 2;
    int64_t d;
    while ((d = myers_distance_fixed(q, m, t, n, x, -1, nullptr, st)) < 0) {
        x *= 2;
    }
    // the verified distance is the tightest provably-sufficient band
    banded_align_rec(q, m, t, n, std::max<int64_t>(d, 1), ops);
    return d;
}

// ---------------------------------------------------------------------- //
// full-matrix linear-gap NW (maximize), for layer-vs-backbone alignment
// ---------------------------------------------------------------------- //

int64_t nw_score_align(const uint8_t* q, int64_t m, const uint8_t* t,
                       int64_t n, int32_t match, int32_t mismatch, int32_t gap,
                       std::vector<OpRun>& ops, std::vector<uint8_t>& moves,
                       std::vector<int32_t>& h_prev, std::vector<int32_t>& h_cur) {
    ops.clear();
    if (m == 0) {
        push_op(ops, OP_DEL, static_cast<int32_t>(n));
        return static_cast<int64_t>(n) * gap;
    }
    if (n == 0) {
        push_op(ops, OP_INS, static_cast<int32_t>(m));
        return static_cast<int64_t>(m) * gap;
    }
    moves.resize(static_cast<size_t>(m + 1) * (n + 1));
    h_prev.resize(n + 1);
    h_cur.resize(n + 1);
    for (int64_t j = 0; j <= n; ++j) {
        h_prev[j] = static_cast<int32_t>(j) * gap;
        moves[j] = 2;
    }
    for (int64_t i = 1; i <= m; ++i) {
        const uint8_t qc = q[i - 1];
        h_cur[0] = static_cast<int32_t>(i) * gap;
        uint8_t* mrow = moves.data() + static_cast<size_t>(i) * (n + 1);
        mrow[0] = 1;
        for (int64_t j = 1; j <= n; ++j) {
            const int32_t diag =
                h_prev[j - 1] + (qc == t[j - 1] ? match : mismatch);
            const int32_t up = h_prev[j] + gap;
            const int32_t left = h_cur[j - 1] + gap;
            int32_t best = std::max(diag, std::max(up, left));
            mrow[j] = (diag == best) ? 0 : (up == best ? 1 : 2);
            h_cur[j] = best;
        }
        std::swap(h_prev, h_cur);
    }
    const int64_t score = h_prev[n];
    std::vector<OpRun> rev;
    int64_t i = m, j = n;
    while (i > 0 || j > 0) {
        const uint8_t mv = moves[static_cast<size_t>(i) * (n + 1) + j];
        if (mv == 0) {
            push_op(rev, OP_MATCH, 1);
            --i;
            --j;
        } else if (mv == 1) {
            push_op(rev, OP_INS, 1);
            --i;
        } else {
            push_op(rev, OP_DEL, 1);
            --j;
        }
    }
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
        push_op(ops, it->op, it->run);
    }
    return score;
}

// ---------------------------------------------------------------------- //
// breaking-point walk (reference semantics: src/overlap.cpp:226-292)
// ---------------------------------------------------------------------- //

int64_t breaking_points(const OpRun* ops, int64_t n_ops, bool strand,
                        int64_t q_begin, int64_t q_end, int64_t q_length,
                        int64_t t_begin, int64_t t_end, int32_t window_length,
                        int64_t* out /* quads */, int64_t max_quads) {
    // window ends: i-1 for every multiple i of w in (t_begin, t_end), then
    // t_end-1
    std::vector<int64_t> window_ends;
    for (int64_t i = 0; i < t_end; i += window_length) {
        if (i > t_begin) window_ends.push_back(i - 1);
    }
    window_ends.push_back(t_end - 1);

    int64_t n_out = 0;
    size_t w = 0;
    bool found = false;
    int64_t fm_t = 0, fm_q = 0, lm_t = 0, lm_q = 0;
    int64_t q_ptr = (strand ? (q_length - q_end) : q_begin) - 1;
    int64_t t_ptr = t_begin - 1;

    for (int64_t k = 0; k < n_ops; ++k) {
        const int32_t op = ops[k].op;
        const int32_t num = ops[k].run;
        if (op == OP_MATCH) {
            for (int32_t u = 0; u < num; ++u) {
                ++q_ptr;
                ++t_ptr;
                if (!found) {
                    found = true;
                    fm_t = t_ptr;
                    fm_q = q_ptr;
                }
                lm_t = t_ptr + 1;
                lm_q = q_ptr + 1;
                if (w < window_ends.size() && t_ptr == window_ends[w]) {
                    if (found && n_out < max_quads) {
                        out[n_out * 4 + 0] = fm_t;
                        out[n_out * 4 + 1] = fm_q;
                        out[n_out * 4 + 2] = lm_t;
                        out[n_out * 4 + 3] = lm_q;
                        ++n_out;
                    }
                    found = false;
                    ++w;
                }
            }
        } else if (op == OP_INS) {
            q_ptr += num;
        } else if (op == OP_DEL) {
            for (int32_t u = 0; u < num; ++u) {
                ++t_ptr;
                if (w < window_ends.size() && t_ptr == window_ends[w]) {
                    if (found && n_out < max_quads) {
                        out[n_out * 4 + 0] = fm_t;
                        out[n_out * 4 + 1] = fm_q;
                        out[n_out * 4 + 2] = lm_t;
                        out[n_out * 4 + 3] = lm_q;
                        ++n_out;
                    }
                    found = false;
                    ++w;
                }
            }
        }
    }
    return n_out;
}

}  // namespace rt
