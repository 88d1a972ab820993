// Knapsack dynamic-programming core for the strategy search.
//
// Same recurrence as the reference's pybind11 core (csrc/dp_core.cpp:24-121
// dynamic_programming_core): f[v][s] = min_si f[v - mem(i,s)][si]
// + inter(i,si,s) + intra(i,s), walked back through the mark table, with the
// vocab-layer memory/time folded in at the budget boundary. Exposed through a
// plain C ABI for ctypes (this image has no pybind11); one (other_mem,
// other_time) pair per call instead of the reference's legacy map-of-vtp.
//
// Build: make -C csrc  (g++ -O2 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Returns 0 on success, 1 when no in-budget assignment exists.
// v:      [layer_num x strategy_num] int32 per-layer memory cost (MB)
// inter:  [layer_num x strategy_num x strategy_num] transition costs
// intra:  [layer_num x strategy_num] per-layer time costs
// mark:   [layer_num x max_mem x strategy_num] int32 workspace
// f:      [max_mem x strategy_num] double workspace (zero-initialised)
// res:    [layer_num] int32 output strategy indices
int dp_solve(int layer_num, int max_mem, int strategy_num,
             const int32_t* v, const double* inter, const double* intra,
             int other_mem, double other_time,
             int32_t* mark, double* f, int32_t* res,
             double* total_cost_out, int* remaining_mem_out) {
    const double INF = std::numeric_limits<double>::infinity();

    for (int i = 0; i < layer_num; ++i) {
        for (int m = max_mem - 1; m >= 0; --m) {
            for (int s = 0; s < strategy_num; ++s) {
                const int need = v[i * strategy_num + s];
                if (m < need) {
                    mark[(int64_t)i * max_mem * strategy_num +
                         (int64_t)m * strategy_num + s] = -1;
                    f[m * strategy_num + s] = INF;
                    continue;
                }
                const double* prev = f + (int64_t)(m - need) * strategy_num;
                const double* tr =
                    inter + (int64_t)i * strategy_num * strategy_num;
                double best = INF;
                int best_si = 0;
                for (int si = 0; si < strategy_num; ++si) {
                    const double c = prev[si] + tr[si * strategy_num + s];
                    if (c < best) {
                        best = c;
                        best_si = si;
                    }
                }
                mark[(int64_t)i * max_mem * strategy_num +
                     (int64_t)m * strategy_num + s] = best_si;
                f[m * strategy_num + s] = best + intra[i * strategy_num + s];
            }
        }
    }

    int budget = max_mem - 1 - other_mem;
    if (budget < 0) {
        *total_cost_out = INF;
        *remaining_mem_out = -1;
        return 1;
    }
    const double* last = f + (int64_t)budget * strategy_num;
    int next_index = (int)std::distance(
        last, std::min_element(last, last + strategy_num));
    int next_v = budget;
    double total = last[next_index];
    if (!(total < INF)) {
        *total_cost_out = INF;
        *remaining_mem_out = -1;
        return 1;
    }
    total += other_time;

    res[layer_num - 1] = next_index;
    for (int i = layer_num - 1; i > 0; --i) {
        const int cur = next_index;
        next_index = mark[(int64_t)i * max_mem * strategy_num +
                          (int64_t)next_v * strategy_num + next_index];
        next_v -= v[i * strategy_num + cur];
        res[i - 1] = next_index;
    }
    *total_cost_out = total;
    *remaining_mem_out = next_v - v[next_index];
    return 0;
}

}  // extern "C"
