#pragma once

#include "common.hpp"

namespace rt {

// exact edit distance (adaptive banded NW, unit costs)
int64_t edit_distance(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n);

// exact edit-distance alignment; fills ops, returns distance
int64_t edit_align(const uint8_t* q, int64_t m, const uint8_t* t, int64_t n,
                   std::vector<OpRun>& ops);

// full-matrix linear-gap NW (maximize); scratch buffers supplied by caller so
// per-thread reuse avoids reallocation
int64_t nw_score_align(const uint8_t* q, int64_t m, const uint8_t* t,
                       int64_t n, int32_t match, int32_t mismatch, int32_t gap,
                       std::vector<OpRun>& ops, std::vector<uint8_t>& moves,
                       std::vector<int32_t>& h_prev, std::vector<int32_t>& h_cur);

// reference-exact window breaking-point walk; returns number of quads written
int64_t breaking_points(const OpRun* ops, int64_t n_ops, bool strand,
                        int64_t q_begin, int64_t q_end, int64_t q_length,
                        int64_t t_begin, int64_t t_end, int32_t window_length,
                        int64_t* out, int64_t max_quads);

}  // namespace rt
