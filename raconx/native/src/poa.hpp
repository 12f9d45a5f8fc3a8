#pragma once

#include "common.hpp"

namespace rt {

struct LayerView {
    const uint8_t* data;
    const int32_t* weights;  // per-base weights (phred-33, or 1s)
    int64_t len;
    int32_t begin;  // inclusive ORIGINAL-backbone coords
    int32_t end;
    const OpRun* ops;  // precomputed alignment (nullptr -> align here)
    int64_t n_ops;
};

struct PoaScratch {
    std::vector<OpRun> ops;
    std::vector<uint8_t> moves;
    std::vector<int32_t> h_prev, h_cur;
};

// Parameters of iterative star-POA refinement. Pass 1 aligns layers to the
// raw window backbone; between passes the backbone is replaced by the
// consensus EXPANDED with high-support off-path insertion candidates as
// zero-deletion-cost "optional" columns, so the next pass's alignments can
// match them (the role progressive graph alignment plays in spoa).
struct RefineParams {
    int32_t passes = 4;
    double cand_frac = 0.15;  // candidate support threshold as layer fraction
    int32_t cand_min = 2;     // absolute minimum support
    int32_t max_growth_num = 2;  // cap expanded length at 2x original
};

// State of one window's refinement between rounds (host-side loop or device
// round-driver).
struct RoundState {
    std::vector<uint8_t> cur;       // current backbone
    std::vector<int32_t> cur_w;     // its weights
    std::vector<int32_t> cur_del;   // per-column deletion cost (gap or 0)
    std::vector<int32_t> cur_slots; // map to ORIGINAL backbone coords
};

// One merge round: build the star graph from per-layer alignments (ops
// required), then either emit the final consensus (trim etc) or the expanded
// backbone for the next round into `state`.
// Returns consensus length (final) or new backbone length (intermediate).
// Intermediate rounds can additionally emit the would-be-final consensus off
// the same graph (fin_out/fin_len/fin_polished) and report whether the round
// was a fixed point (converged) -- later rounds would then reproduce it
// bit-for-bit, so the caller can retire the window with fin_out directly.
int64_t poa_round(RoundState& state, int64_t n_layers, const LayerView* layers,
                  bool final_round, const RefineParams& rp, bool tgs,
                  bool trim, int32_t gap, uint8_t* out, int64_t out_capacity,
                  bool* polished, int64_t window_id, int32_t rank,
                  uint8_t* fin_out = nullptr, int64_t fin_capacity = 0,
                  int64_t* fin_len = nullptr, bool* fin_polished = nullptr,
                  bool* converged = nullptr);

// full multi-pass window consensus with host-side alignment
int64_t consensus_window(
    const uint8_t* backbone, int32_t backbone_len, const int32_t* backbone_w,
    int64_t n_layers, const LayerView* layers, bool tgs, bool trim,
    int32_t match, int32_t mismatch, int32_t gap, const RefineParams& rp,
    uint8_t* out, int64_t out_capacity, bool* polished, int64_t window_id,
    int32_t rank, PoaScratch& scratch);

// project [begin, end] (original coords) onto cur via cur_slots; applies the
// reference's 1%-of-backbone full-span rule
void project_span(const std::vector<int32_t>& cur_slots, int32_t begin,
                  int32_t end, int32_t* sub_begin, int32_t* sub_end);

// per-column-deletion-cost NW (maximize); del_cost[j] = cost of consuming
// t[j] by deletion (normally `gap`, 0 for optional columns)
int64_t nw_score_align_percol(const uint8_t* q, int64_t m, const uint8_t* t,
                              int64_t n, const int32_t* del_cost,
                              int32_t match, int32_t mismatch, int32_t gap,
                              std::vector<OpRun>& ops,
                              std::vector<uint8_t>& moves,
                              std::vector<int32_t>& h_prev,
                              std::vector<int32_t>& h_cur);

}  // namespace rt

#include <atomic>

namespace rt {
// env-gated merge phase profiling (see poa.cpp)
extern std::atomic<int64_t> g_prof_build, g_prof_bundle, g_prof_emit;
}  // namespace rt
