// Shared types and helpers for the raconx native host runtime.
//
// The runtime plays the roles that vendored native libraries play in the
// reference (bioparser / edlib / spoa / thread_pool -- see SURVEY.md sec 2.2),
// re-implemented from scratch for this framework's columnar data model and
// consumed from Python through a plain C API (capi.cpp).
#pragma once

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace rt {

// alignment op codes, shared with python (raconx/core/breakpoints.py)
enum Op : int32_t { OP_MATCH = 0, OP_INS = 1, OP_DEL = 2 };

struct OpRun {
    int32_t op;
    int32_t run;
};

// run fn(i) for i in [0, n) on up to n_threads threads
inline void parallel_for(int64_t n, int32_t n_threads,
                         const std::function<void(int64_t, int32_t)>& fn) {
    if (n <= 0) return;
    int32_t t = n_threads < 1 ? 1 : n_threads;
    if (t == 1 || n == 1) {
        for (int64_t i = 0; i < n; ++i) fn(i, 0);
        return;
    }
    std::atomic<int64_t> next(0);
    std::vector<std::thread> threads;
    int32_t spawn = static_cast<int32_t>(t < n ? t : n);
    threads.reserve(spawn);
    for (int32_t w = 0; w < spawn; ++w) {
        threads.emplace_back([&, w]() {
            while (true) {
                int64_t i = next.fetch_add(1);
                if (i >= n) break;
                fn(i, w);
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace rt
