// Per-op ORSWOT apply loop in C++ — the honest *upper bound* on what the
// reference's BEAM materializer hot loop (reference
// src/clocksi_materializer.erl:145-171 materialize_intern + antidote_crdt
// set_aw update) can do per scheduler core: one op at a time, hash-map
// state, generic observed-remove set semantics.  BEAM runs the same
// algorithm with immutable terms and a reduction-counting interpreter, so
// ops/s(BEAM) <= ops/s(this loop); reporting device_ops / cpp_ops is a
// conservative bound on the true device-vs-BEAM ratio (BASELINE.md asks
// for the BEAM yardstick; no Erlang runtime exists in this image, so we
// bound it instead of guessing).
//
// C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <chrono>
#include <unordered_map>
#include <vector>

namespace {

struct Dot {
    int32_t dc;
    int64_t seq;
};

// state per (key, elem): live dot list (tiny — semantics of ORSWOT keep
// one dot per writing DC in steady state)
struct KeyState {
    std::unordered_map<int32_t, std::vector<Dot>> elems;
};

}  // namespace

extern "C" {

// Applies n_ops sequentially; returns elapsed seconds.  Arrays are the
// same synthetic stream the Python baseline consumes: key[i], is_add[i],
// elem[i], dot_dc[i], dot_seq[i].
double orset_baseline_run(int64_t n_ops, const int64_t* key,
                          const uint8_t* is_add, const int32_t* elem,
                          const int32_t* dot_dc, const int64_t* dot_seq,
                          int64_t* out_live_dots) {
    std::unordered_map<int64_t, KeyState> states;
    auto t0 = std::chrono::steady_clock::now();
    for (int64_t i = 0; i < n_ops; i++) {
        KeyState& st = states[key[i]];
        std::vector<Dot>& dots = st.elems[elem[i]];
        // observed = snapshot of current dots (the downstream "observed
        // context", reference antidote_crdt_set_aw:downstream)
        std::vector<Dot> observed = dots;
        // remove observed dots (generic set difference, as BEAM does)
        std::vector<Dot> next;
        next.reserve(dots.size() + 1);
        for (const Dot& d : dots) {
            bool seen = false;
            for (const Dot& o : observed)
                if (o.dc == d.dc && o.seq == d.seq) { seen = true; break; }
            if (!seen) next.push_back(d);
        }
        if (is_add[i]) next.push_back(Dot{dot_dc[i], dot_seq[i]});
        dots.swap(next);
    }
    auto t1 = std::chrono::steady_clock::now();
    // fold a checksum so the optimizer cannot dead-code the loop
    int64_t live = 0;
    for (auto& [k, st] : states)
        for (auto& [e, dots] : st.elems) live += (int64_t)dots.size();
    *out_live_dots = live;
    return std::chrono::duration<double>(t1 - t0).count();
}

}  // extern "C"
