// Iterative star partial-order consensus -- the native production
// implementation of raconx/ops/poa_host.py (see that module's docstring
// for the design and its relation to the reference's spoa engine).
//
// Layers arrive either as raw sequences (aligned here, per-column deletion
// costs) or with precomputed op lists (the GPU path: device banded-NW
// produces the alignments; LayerView.begin/end then hold the cur-coordinate
// span the alignment was computed against).

#include "poa.hpp"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdlib>

#include "align.hpp"

namespace rt {

// env-gated phase profiling (RT_POA_PROF=1): nanoseconds per merge phase,
// read back via rt_poa_prof_ns(). Atomic adds are off the hot path (once
// per window-round), so the instrumentation is free when disabled.
std::atomic<int64_t> g_prof_build{0}, g_prof_bundle{0}, g_prof_emit{0};
static const bool g_prof_on = [] {
    const char* e = std::getenv("RT_POA_PROF");
    return e && e[0] == '1';
}();

namespace {

inline int64_t prof_now() {
    return g_prof_on ? std::chrono::duration_cast<std::chrono::nanoseconds>(
                           std::chrono::steady_clock::now()
                               .time_since_epoch())
                           .count()
                     : 0;
}

inline int32_t base_code(uint8_t b) {
    switch (b) {
        case 'A': return 0;
        case 'C': return 1;
        case 'G': return 2;
        case 'T': return 3;
        default: return -1;
    }
}

struct Graph {
    // Structure-of-arrays storage + linked adjacency with TAIL insertion:
    // list iteration follows creation order exactly like a vector<vector>
    // layout (heaviest-bundle tie-breaking and rank order depend on it).
    // SoA keeps the add_path hot loop's working set dense — the byte-wide
    // base array and the int32 coverage array stream through cache instead
    // of striding over 16-byte node structs. A thread_local instance is
    // reused across windows with zero per-node heap traffic.
    int32_t backbone_len;
    // per node
    std::vector<uint8_t> n_base;
    std::vector<int32_t> n_col;    // backbone column, -1 for insertion nodes
    std::vector<int32_t> n_slot;   // ordering slot (gap index for insertions)
    std::vector<int32_t> n_cov;
    std::vector<int32_t> first_in, last_in, first_out, last_out;
    std::vector<int32_t> node_next;  // next in its variant/ins list
    // per edge
    std::vector<int32_t> e_tail, e_head;
    std::vector<int64_t> e_weight;
    std::vector<int32_t> next_in, next_out;
    // per column
    std::vector<int32_t> var_head, var_tail;
    // direct-mapped variant lookup: var_map[4*t + code(b)] = the (unique)
    // variant node with base b at backbone column t, or -1. The ring
    // (var_head/node_next) is kept for creation-order iteration in
    // bundle/emit; add_path's hot lookup becomes one indexed load instead
    // of a pointer chase. Non-ACGT bases (no 2-bit code) fall back to the
    // ring scan.
    std::vector<int32_t> var_map;
    // insertion nodes are column-aligned per gap: ins_head[gap][depth] heads
    // a node list so identical inserted bases from different layers share one
    // node and votes concentrate (the role graph alignment plays in
    // sequential POA)
    std::vector<std::vector<int32_t>> ins_head, ins_tail;
    // heaviest_bundle scratch
    std::vector<int32_t> rank_scratch, node_rank_scratch, pred_scratch;
    std::vector<int64_t> scores_scratch;

    int64_t n_nodes() const { return static_cast<int64_t>(n_base.size()); }

    int32_t new_node(uint8_t base, int32_t col, int32_t slot) {
        n_base.push_back(base);
        n_col.push_back(col);
        n_slot.push_back(slot);
        n_cov.push_back(0);
        first_in.push_back(-1);
        last_in.push_back(-1);
        first_out.push_back(-1);
        last_out.push_back(-1);
        node_next.push_back(-1);
        return static_cast<int32_t>(n_base.size()) - 1;
    }

    void bump_edge(int32_t u, int32_t v, int64_t w) {
        for (int32_t e = first_out[u]; e >= 0; e = next_out[e]) {
            if (e_head[e] == v) {
                e_weight[e] += w;
                return;
            }
        }
        const int32_t e = static_cast<int32_t>(e_tail.size());
        e_tail.push_back(u);
        e_head.push_back(v);
        e_weight.push_back(w);
        next_in.push_back(-1);
        next_out.push_back(-1);
        if (last_out[u] >= 0) next_out[last_out[u]] = e; else first_out[u] = e;
        last_out[u] = e;
        if (last_in[v] >= 0) next_in[last_in[v]] = e; else first_in[v] = e;
        last_in[v] = e;
    }

    // append a new edge known not to exist yet (head was just created):
    // bump_edge minus the guaranteed-miss out-list scan
    void add_edge_new(int32_t u, int32_t v, int64_t w) {
        const int32_t e = static_cast<int32_t>(e_tail.size());
        e_tail.push_back(u);
        e_head.push_back(v);
        e_weight.push_back(w);
        next_in.push_back(-1);
        next_out.push_back(-1);
        if (last_out[u] >= 0) next_out[last_out[u]] = e; else first_out[u] = e;
        last_out[u] = e;
        if (last_in[v] >= 0) next_in[last_in[v]] = e; else first_in[v] = e;
        last_in[v] = e;
    }

    void init(const uint8_t* backbone, int32_t len, const int32_t* weights) {
        backbone_len = len;
        // bulk backbone construction (identical node/edge ids and list
        // order to one new_node/bump_edge per column: node c = column c,
        // edge c = (c -> c+1))
        n_base.assign(backbone, backbone + len);
        n_col.resize(len);
        n_slot.resize(len);
        for (int32_t c = 0; c < len; ++c) n_col[c] = c;
        std::copy(n_col.begin(), n_col.end(), n_slot.begin());
        n_cov.assign(len, 1);
        node_next.assign(len, -1);
        first_in.resize(len);
        last_in.resize(len);
        first_out.resize(len);
        last_out.resize(len);
        e_tail.resize(len > 0 ? len - 1 : 0);
        e_head.resize(e_tail.size());
        e_weight.resize(e_tail.size());
        next_in.assign(e_tail.size(), -1);
        next_out.assign(e_tail.size(), -1);
        for (int32_t c = 0; c + 1 < len; ++c) {
            e_tail[c] = c;
            e_head[c] = c + 1;
            e_weight[c] = int64_t(weights[c]) + weights[c + 1];
            first_out[c] = c;
            last_out[c] = c;
            first_in[c + 1] = c;
            last_in[c + 1] = c;
        }
        if (len > 0) {
            first_in[0] = -1;
            last_in[0] = -1;
            first_out[len - 1] = -1;
            last_out[len - 1] = -1;
        }
        var_head.assign(len, -1);
        var_tail.assign(len, -1);
        var_map.assign(4 * static_cast<size_t>(len), -1);
        if (static_cast<int32_t>(ins_head.size()) < len + 1) {
            ins_head.resize(len + 1);
            ins_tail.resize(len + 1);
        }
        for (int32_t c = 0; c <= len; ++c) {
            ins_head[c].clear();
            ins_tail[c].clear();
        }
    }

    void add_path(const OpRun* ops, int64_t n_ops, int32_t t_offset,
                  const uint8_t* data, const int32_t* weights) {
        int32_t prev = -1;
        int64_t q = 0;
        int32_t t = t_offset;
        int32_t ins_depth = 0;  // consecutive insertions since last match/del
        for (int64_t k = 0; k < n_ops; ++k) {
            const int32_t op = ops[k].op;
            const int32_t run = ops[k].run;
            if (op != OP_INS) ins_depth = 0;
            if (op == OP_MATCH) {
                int32_t u = 0;
                while (u < run) {
                    // fast span: consecutive diagonal positions whose base
                    // EQUALS the backbone base, entered from the previous
                    // backbone node — the graph writes reduce to coverage
                    // increments and direct-indexed backbone-edge weight
                    // adds (init creates edge c-1 as (c-1 -> c)), with no
                    // variant-ring or out-list scans. Bit-identical graph:
                    // no nodes or edges are created or reordered here.
                    if (prev == t - 1 && prev >= 0 && n_base[t] == data[q]) {
                        // word-at-a-time mismatch scan: match runs stay
                        // inside backbone columns (t + run <= backbone_len
                        // <= n_base.size()) and inside the layer (q + run
                        // <= len), so 8-byte loads below never leave either
                        // buffer
                        // ctzll(x) >> 3 finds the first differing BYTE
                        // only when byte 0 holds the lowest bits
                        static_assert(__BYTE_ORDER__ ==
                                          __ORDER_LITTLE_ENDIAN__,
                                      "word-at-a-time mismatch scan assumes "
                                      "little-endian byte order");
                        int32_t d = 1;
                        while (u + d + 8 <= run) {
                            uint64_t a, b;
                            memcpy(&a, n_base.data() + t + d, 8);
                            memcpy(&b, data + q + d, 8);
                            const uint64_t x = a ^ b;
                            if (x) {
                                d += __builtin_ctzll(x) >> 3;
                                break;
                            }
                            d += 8;
                        }
                        while (u + d < run &&
                               n_base[t + d] == data[q + d]) {
                            ++d;
                        }
                        for (int32_t x = 0; x < d; ++x) {
                            n_cov[t + x] += 1;
                        }
                        for (int32_t x = 0; x < d; ++x) {
                            e_weight[t + x - 1] +=
                                int64_t(weights[q + x - 1]) + weights[q + x];
                        }
                        q += d;
                        t += d;
                        u += d;
                        prev = t - 1;
                        continue;
                    }
                    const uint8_t b = data[q];
                    int32_t node;
                    bool created = false;
                    if (n_base[t] == b) {
                        node = t;
                    } else {
                        const int32_t bc = base_code(b);
                        if (bc >= 0) {
                            node = var_map[4 * static_cast<size_t>(t) + bc];
                        } else {
                            node = -1;
                            for (int32_t v = var_head[t]; v >= 0;
                                 v = node_next[v]) {
                                if (n_base[v] == b) {
                                    node = v;
                                    break;
                                }
                            }
                        }
                        if (node < 0) {
                            node = new_node(b, t, t);
                            if (var_tail[t] >= 0) node_next[var_tail[t]] = node;
                            else var_head[t] = node;
                            var_tail[t] = node;
                            if (bc >= 0) {
                                var_map[4 * static_cast<size_t>(t) + bc] =
                                    node;
                            }
                            created = true;
                        }
                    }
                    n_cov[node] += 1;
                    if (prev >= 0) {
                        const int64_t w =
                            int64_t(weights[q - 1]) + weights[q];
                        if (created) add_edge_new(prev, node, w);
                        else bump_edge(prev, node, w);
                    }
                    prev = node;
                    ++q;
                    ++t;
                    ++u;
                }
            } else if (op == OP_INS) {
                for (int32_t u = 0; u < run; ++u) {
                    const uint8_t b = data[q];
                    const int32_t depth = ins_depth++;
                    auto& heads = ins_head[t];
                    auto& tails = ins_tail[t];
                    if (static_cast<int32_t>(heads.size()) <= depth) {
                        heads.resize(depth + 1, -1);
                        tails.resize(depth + 1, -1);
                    }
                    int32_t node = -1;
                    bool created = false;
                    for (int32_t v = heads[depth]; v >= 0; v = node_next[v]) {
                        if (n_base[v] == b) {
                            node = v;
                            break;
                        }
                    }
                    if (node < 0) {
                        node = new_node(b, -1, t);
                        if (tails[depth] >= 0) node_next[tails[depth]] = node;
                        else heads[depth] = node;
                        tails[depth] = node;
                        created = true;
                    }
                    n_cov[node] += 1;
                    if (prev >= 0) {
                        const int64_t w =
                            int64_t(weights[q - 1]) + weights[q];
                        if (created) add_edge_new(prev, node, w);
                        else bump_edge(prev, node, w);
                    }
                    prev = node;
                    ++q;
                }
            } else {
                t += run;
            }
        }
    }

    // topological order: per slot, gap insertion columns (by depth, then
    // creation) then the backbone node and its variants
    void rank_order(std::vector<int32_t>& rank) const {
        rank.clear();
        rank.reserve(n_nodes());
        for (int32_t c = 0; c < backbone_len; ++c) {
            for (int32_t h : ins_head[c]) {
                for (int32_t v = h; v >= 0; v = node_next[v]) rank.push_back(v);
            }
            rank.push_back(c);
            for (int32_t v = var_head[c]; v >= 0; v = node_next[v]) {
                rank.push_back(v);
            }
        }
        for (int32_t h : ins_head[backbone_len]) {
            for (int32_t v = h; v >= 0; v = node_next[v]) rank.push_back(v);
        }
    }

    // spoa-semantics heaviest bundle + branch completion
    void heaviest_bundle(std::vector<int32_t>& path) {
        const int64_t n = static_cast<int64_t>(n_nodes());
        std::vector<int32_t>& rank = rank_scratch;
        rank_order(rank);
        std::vector<int32_t>& node_rank = node_rank_scratch;
        node_rank.resize(n);
        for (int64_t r = 0; r < n; ++r) {
            node_rank[rank[r]] = static_cast<int32_t>(r);
        }
        std::vector<int64_t>& scores = scores_scratch;
        std::vector<int32_t>& pred = pred_scratch;
        scores.assign(n, -1);
        pred.assign(n, -1);

        int32_t best = -1;
        for (int64_t r = 0; r < n; ++r) {
            const int32_t v = rank[r];
            for (int32_t e = first_in[v]; e >= 0; e = next_in[e]) {
                const int32_t u = e_tail[e];
                const int64_t w = e_weight[e];
                if (scores[v] < w ||
                    (scores[v] == w && scores[pred[v]] <= scores[u])) {
                    scores[v] = w;
                    pred[v] = u;
                }
            }
            if (pred[v] >= 0) scores[v] += scores[pred[v]];
            if (best < 0 || scores[best] < scores[v]) best = v;
        }

        while (first_out[best] >= 0) {
            // ban side-branch tails of the current tip, then rescore the
            // downstream ranks
            for (int32_t e = first_out[best]; e >= 0; e = next_out[e]) {
                const int32_t head = e_head[e];
                for (int32_t e2 = first_in[head]; e2 >= 0; e2 = next_in[e2]) {
                    if (e_tail[e2] != best) scores[e_tail[e2]] = -1;
                }
            }
            int64_t max_score = 0;
            int32_t max_node = -1;
            for (int64_t r = node_rank[best] + 1; r < n; ++r) {
                const int32_t v = rank[r];
                scores[v] = -1;
                pred[v] = -1;
                for (int32_t e = first_in[v]; e >= 0; e = next_in[e]) {
                    const int32_t u = e_tail[e];
                    if (scores[u] == -1) continue;
                    const int64_t w = e_weight[e];
                    if (scores[v] < w ||
                        (scores[v] == w && scores[pred[v]] <= scores[u])) {
                        scores[v] = w;
                        pred[v] = u;
                    }
                }
                if (pred[v] >= 0) scores[v] += scores[pred[v]];
                if (max_score < scores[v]) {
                    max_score = scores[v];
                    max_node = v;
                }
            }
            if (max_node < 0) break;
            best = max_node;
        }

        path.clear();
        for (int32_t v = best; v >= 0; v = pred[v]) path.push_back(v);
        std::reverse(path.begin(), path.end());
    }

    int64_t column_coverage(int32_t v) const {
        int64_t c = n_cov[v];
        const int32_t col = n_col[v];
        if (col >= 0) {
            for (int32_t x = var_head[col]; x >= 0; x = node_next[x]) {
                if (x != v) c += n_cov[x];
            }
            if (v != col) c += n_cov[col];
        }
        return c;
    }
};

}  // namespace

// project [begin, end] (original coords) onto cur via cur_slots; apply the
// reference's 1%-of-backbone full-span rule (src/window.cpp:87-92)
void project_span(const std::vector<int32_t>& cur_slots, int32_t begin,
                  int32_t end, int32_t* sub_begin, int32_t* sub_end) {
    const int32_t n = static_cast<int32_t>(cur_slots.size());
    int32_t b = static_cast<int32_t>(
        std::lower_bound(cur_slots.begin(), cur_slots.end(), begin) -
        cur_slots.begin());
    int32_t e = static_cast<int32_t>(
        std::upper_bound(cur_slots.begin(), cur_slots.end(), end) -
        cur_slots.begin()) - 1;
    b = std::max(0, std::min(b, n - 1));
    e = std::max(b, std::min(e, n - 1));
    const double offset = 0.01 * n;
    if (b < offset && e > n - offset) {
        b = 0;
        e = n - 1;
    }
    *sub_begin = b;
    *sub_end = e;
}

int64_t nw_score_align_percol(const uint8_t* q, int64_t m, const uint8_t* t,
                              int64_t n, const int32_t* del_cost,
                              int32_t match, int32_t mismatch, int32_t gap,
                              std::vector<OpRun>& ops,
                              std::vector<uint8_t>& moves,
                              std::vector<int32_t>& h_prev,
                              std::vector<int32_t>& h_cur) {
    ops.clear();
    if (m == 0) {
        if (n > 0) ops.push_back({OP_DEL, static_cast<int32_t>(n)});
        int64_t s = 0;
        for (int64_t j = 0; j < n; ++j) s += del_cost[j];
        return s;
    }
    if (n == 0) {
        ops.push_back({OP_INS, static_cast<int32_t>(m)});
        return static_cast<int64_t>(m) * gap;
    }
    moves.resize(static_cast<size_t>(m + 1) * (n + 1));
    h_prev.resize(n + 1);
    h_cur.resize(n + 1);
    h_prev[0] = 0;
    moves[0] = 3;
    for (int64_t j = 1; j <= n; ++j) {
        h_prev[j] = h_prev[j - 1] + del_cost[j - 1];
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
            const int32_t left = h_cur[j - 1] + del_cost[j - 1];
            const int32_t bestv = std::max(diag, std::max(up, left));
            mrow[j] = (diag == bestv) ? 0 : (up == bestv ? 1 : 2);
            h_cur[j] = bestv;
        }
        std::swap(h_prev, h_cur);
    }
    const int64_t score = h_prev[n];
    std::vector<OpRun> rev;
    int64_t i = m, j = n;
    auto push = [&rev](int32_t op) {
        if (!rev.empty() && rev.back().op == op) {
            rev.back().run += 1;
        } else {
            rev.push_back({op, 1});
        }
    };
    while (i > 0 || j > 0) {
        const uint8_t mv = moves[static_cast<size_t>(i) * (n + 1) + j];
        if (mv == 0) {
            push(OP_MATCH);
            --i;
            --j;
        } else if (mv == 1) {
            push(OP_INS);
            --i;
        } else {
            push(OP_DEL);
            --j;
        }
    }
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
        if (!ops.empty() && ops.back().op == it->op) {
            ops.back().run += it->run;
        } else {
            ops.push_back(*it);
        }
    }
    return score;
}

int64_t poa_round(RoundState& state, int64_t n_layers, const LayerView* layers,
                  bool final_round, const RefineParams& rp, bool tgs,
                  bool trim, int32_t gap, uint8_t* out, int64_t out_capacity,
                  bool* polished, int64_t window_id, int32_t rank,
                  uint8_t* fin_out, int64_t fin_capacity, int64_t* fin_len,
                  bool* fin_polished, bool* converged) {
    thread_local Graph g;  // reused across windows: zero per-node heap churn
    const int64_t t0 = prof_now();
    g.init(state.cur.data(), static_cast<int32_t>(state.cur.size()),
           state.cur_w.data());
    for (int64_t i = 0; i < n_layers; ++i) {
        const LayerView& L = layers[i];
        // ops are required here; begin holds the cur-coordinate span start
        g.add_path(L.ops, L.n_ops, L.begin, L.data, L.weights);
    }
    const int64_t t1 = prof_now();
    thread_local std::vector<int32_t> path;
    g.heaviest_bundle(path);
    const int64_t t2 = prof_now();
    if (g_prof_on) {
        g_prof_build += t1 - t0;
        g_prof_bundle += t2 - t1;
    }

    // final consensus off this round's graph: trimming per the reference
    // (src/window.cpp:118-139). warn_chimeric gates the stderr warning so
    // speculative emissions (intermediate rounds) stay silent unless the
    // round is actually used as the final one (converged -> retired).
    auto emit_final = [&](uint8_t* dst, int64_t cap_, bool warn_chimeric) {
        int64_t begin = 0;
        int64_t end = static_cast<int64_t>(path.size()) - 1;
        if (tgs && trim) {
            const int64_t average = n_layers / 2;
            while (begin < static_cast<int64_t>(path.size()) &&
                   g.column_coverage(path[begin]) < average) {
                ++begin;
            }
            while (end >= 0 && g.column_coverage(path[end]) < average) {
                --end;
            }
            if (begin >= end) {
                if (warn_chimeric) {
                    fprintf(stderr,
                            "[racon::Window::generate_consensus] warning: "
                            "contig %lld might be chimeric in window %d!\n",
                            static_cast<long long>(window_id), rank);
                }
                begin = 0;
                end = static_cast<int64_t>(path.size()) - 1;
            }
        }
        int64_t n = 0;
        for (int64_t i = begin; i <= end && n < cap_; ++i) {
            dst[n++] = g.n_base[path[i]];
        }
        return n;
    };

    if (final_round) {
        const int64_t n = emit_final(out, out_capacity, true);
        if (polished) *polished = true;
        return n;
    }

    // intermediate round: expanded backbone = consensus path + off-path
    // insertion candidates with support >= threshold, as zero-del-cost
    // optional columns
    const int64_t thr = std::max<int64_t>(
        rp.cand_min, static_cast<int64_t>(rp.cand_frac * n_layers));
    // flat candidate list in ascending slot order (consumed by a cursor in
    // the same order below) — avoids constructing n_slots small vectors
    // per window-round; all scratch is thread_local and reused
    thread_local std::vector<uint8_t> on_path;
    on_path.assign(g.n_nodes(), 0);
    for (int32_t v : path) on_path[v] = 1;
    const int32_t n_slots = g.backbone_len + 1;
    thread_local std::vector<int32_t> cand_slot;
    thread_local std::vector<uint8_t> cand_base;
    cand_slot.clear();
    cand_base.clear();
    for (int32_t s = 0; s < n_slots; ++s) {
        for (int32_t h : g.ins_head[s]) {
            int32_t best = -1;
            for (int32_t v = h; v >= 0; v = g.node_next[v]) {
                if (on_path[v]) continue;
                if (g.n_cov[v] >= thr &&
                    (best < 0 ||
                     g.n_cov[v] > g.n_cov[best])) {
                    best = v;
                }
            }
            if (best >= 0) {
                cand_slot.push_back(s);
                cand_base.push_back(g.n_base[best]);
            }
        }
    }
    const int64_t max_len =
        static_cast<int64_t>(state.cur_slots.size()) * rp.max_growth_num + 64;

    std::vector<uint8_t> new_seq;
    std::vector<int32_t> new_del, new_slots_local;
    new_seq.reserve(path.size() + 64);
    size_t cand_cur = 0;
    auto emit_cands_upto = [&](int32_t s) {
        while (cand_cur < cand_slot.size() && cand_slot[cand_cur] <= s) {
            if (static_cast<int64_t>(new_seq.size()) < max_len) {
                new_seq.push_back(cand_base[cand_cur]);
                new_del.push_back(0);
                new_slots_local.push_back(cand_slot[cand_cur]);
            }
            ++cand_cur;
        }
    };
    for (int32_t v : path) {
        const int32_t s = g.n_slot[v];
        emit_cands_upto(s);
        if (static_cast<int64_t>(new_seq.size()) >= max_len) break;
        new_seq.push_back(g.n_base[v]);
        new_del.push_back(gap);
        new_slots_local.push_back(s);
    }
    emit_cands_upto(n_slots - 1);

    // compose slots through to ORIGINAL backbone coordinates
    std::vector<int32_t> composed(new_seq.size());
    const int32_t prev_n = static_cast<int32_t>(state.cur_slots.size());
    for (size_t i = 0; i < new_seq.size(); ++i) {
        const int32_t sl = std::min(new_slots_local[i], prev_n - 1);
        composed[i] = state.cur_slots[sl];
    }

    // convergence: this round was a fixed point (same backbone, deletion
    // costs and slot map) and it ran with zero backbone weights -- exactly
    // what every later round would also use, so they would reproduce this
    // graph bit-for-bit and the final consensus is available NOW.
    bool conv = false;
    if (converged != nullptr) {
        conv = new_seq == state.cur && new_del == state.cur_del &&
               composed == state.cur_slots;
        if (conv) {
            for (int32_t w : state.cur_w) {
                if (w != 0) {
                    conv = false;
                    break;
                }
            }
        }
        *converged = conv;
    }
    if (fin_out != nullptr) {
        // speculative final off the same graph: costs one O(path) pass,
        // saves the separate final merge when the window retires
        const int64_t n = emit_final(fin_out, fin_capacity, conv);
        if (fin_len != nullptr) *fin_len = n;
        if (fin_polished != nullptr) *fin_polished = true;
    }

    state.cur = std::move(new_seq);
    state.cur_w.assign(state.cur.size(), 0);
    state.cur_del = std::move(new_del);
    state.cur_slots = std::move(composed);
    if (polished) *polished = false;
    if (g_prof_on) g_prof_emit += prof_now() - t2;
    return static_cast<int64_t>(state.cur.size());
}

int64_t consensus_window(
    const uint8_t* backbone, int32_t backbone_len, const int32_t* backbone_w,
    int64_t n_layers, const LayerView* layers, bool tgs, bool trim,
    int32_t match, int32_t mismatch, int32_t gap, const RefineParams& rp,
    uint8_t* out, int64_t out_capacity, bool* polished, int64_t window_id,
    int32_t rank, PoaScratch& scratch) {
    if (n_layers < 2) {
        // passthrough (reference: src/window.cpp:68-71)
        const int64_t n = std::min<int64_t>(backbone_len, out_capacity);
        memcpy(out, backbone, n);
        *polished = false;
        return n;
    }

    RoundState st;
    st.cur.assign(backbone, backbone + backbone_len);
    st.cur_w.assign(backbone_w, backbone_w + backbone_len);
    st.cur_del.assign(backbone_len, gap);
    st.cur_slots.resize(backbone_len);
    for (int32_t c = 0; c < backbone_len; ++c) st.cur_slots[c] = c;

    const int32_t passes = std::max(1, rp.passes);
    const bool external_ops = (n_layers > 0 && layers[0].ops != nullptr);
    std::vector<LayerView> round_layers(layers, layers + n_layers);
    std::vector<std::vector<OpRun>> all_ops(n_layers);
    for (int32_t ps = 0; ps < passes; ++ps) {
        const bool final_round = (ps == passes - 1);
        if (!(external_ops && ps == 0)) {
            for (int64_t i = 0; i < n_layers; ++i) {
                const LayerView& L = layers[i];
                int32_t sb, se;
                project_span(st.cur_slots, L.begin, L.end, &sb, &se);
                nw_score_align_percol(
                    L.data, L.len, st.cur.data() + sb, se - sb + 1,
                    st.cur_del.data() + sb, match, mismatch, gap, scratch.ops,
                    scratch.moves, scratch.h_prev, scratch.h_cur);
                all_ops[i] = scratch.ops;
                round_layers[i].ops = all_ops[i].data();
                round_layers[i].n_ops =
                    static_cast<int64_t>(all_ops[i].size());
                round_layers[i].begin = sb;
                round_layers[i].end = se;
            }
        }
        if (final_round) {
            return poa_round(st, n_layers, round_layers.data(), true, rp, tgs,
                             trim, gap, out, out_capacity, polished,
                             window_id, rank);
        }
        // intermediate round: also emit the speculative final + convergence
        // flag so a fixed point skips the remaining (bit-identical) passes
        int64_t fin_n = 0;
        bool fin_pol = false, conv = false;
        poa_round(st, n_layers, round_layers.data(), false, rp, tgs, trim,
                  gap, out, out_capacity, polished, window_id, rank, out,
                  out_capacity, &fin_n, &fin_pol, &conv);
        if (conv) {
            if (polished) *polished = fin_pol;
            return fin_n;
        }
    }
    return 0;  // unreachable
}

}  // namespace rt
