// Copied from hinge_tpu/native/stdcxx_order.cpp, unchanged.
//
// libstdc++ ordering oracles for byte-exact parity with the reference
// binaries.
//
// The reference's per-read match lists are built by iterating
// std::unordered_map<int, std::vector<LOverlap*>> (insertion = first
// appearance in the .las stream; iteration = libstdc++ hashtable layout,
// hinging.cpp:473-506) and then sorted with std::sort — an UNSTABLE
// introsort whose tie permutation downstream files inherit
// (hinging.cpp:1068-1069 weight sort; maximal.cpp:789 / hinging.cpp:530
// per-pair compare_overlap sort).  Rather than re-deriving those layouts,
// these helpers run the real libstdc++ containers/algorithms on shadow
// elements: the permutations depend only on comparator outcomes and
// insertion order, not on the element payload, so they match the reference
// binaries built with the same toolchain.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Iteration order of std::unordered_map<int32 key, ...> after inserting
// `keys` (assumed distinct) in the given order.  out[j] = input index of
// the j-th key in iteration order.  Returns 0.
int umap_iter_order(const int32_t* keys, int64_t n, int32_t* out) {
    std::unordered_map<int32_t, int32_t> m;
    m.reserve(0);  // default rehash policy, like the reference's fresh map
    for (int64_t i = 0; i < n; i++) m.emplace(keys[i], static_cast<int32_t>(i));
    int64_t j = 0;
    for (const auto& kv : m) out[j++] = kv.second;
    return 0;
}

namespace {
struct Item {
    int64_t w;
    int32_t idx;
};
}  // namespace

// Permutation of std::sort with the reference's strict-weak "greater
// weight" comparator (compare_overlap / compare_overlap_weight shape):
// out[j] = original index of the element at sorted position j, including
// introsort's exact (unstable) tie behavior.
int stdsort_desc_perm(const int64_t* weights, int64_t n, int32_t* out) {
    std::vector<Item> v(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++)
        v[static_cast<size_t>(i)] = {weights[i], static_cast<int32_t>(i)};
    std::sort(v.begin(), v.end(),
              [](const Item& a, const Item& b) { return a.w > b.w; });
    for (int64_t i = 0; i < n; i++) out[i] = v[static_cast<size_t>(i)].idx;
    return 0;
}

// Batched variants over contiguous groups: group g spans
// [off[g], off[g+1]) of the flat input; out is written in the same layout
// with indices LOCAL to each group.
int umap_iter_order_batch(const int32_t* keys, const int64_t* off,
                          int64_t n_groups, int32_t* out) {
    for (int64_t g = 0; g < n_groups; g++) {
        const int64_t s = off[g], e = off[g + 1];
        // fresh map per group: the reference creates a fresh inner map per
        // read, and bucket growth history affects the final layout
        std::unordered_map<int32_t, int32_t> m;
        for (int64_t i = s; i < e; i++)
            m.emplace(keys[i], static_cast<int32_t>(i - s));
        int64_t j = s;
        for (const auto& kv : m) out[j++] = kv.second;
    }
    return 0;
}

int stdsort_desc_perm_batch(const int64_t* weights, const int64_t* off,
                            int64_t n_groups, int32_t* out) {
    std::vector<Item> v;
    for (int64_t g = 0; g < n_groups; g++) {
        const int64_t s = off[g], e = off[g + 1];
        v.clear();
        v.reserve(static_cast<size_t>(e - s));
        for (int64_t i = s; i < e; i++)
            v.push_back({weights[i], static_cast<int32_t>(i - s)});
        std::sort(v.begin(), v.end(),
                  [](const Item& a, const Item& b) { return a.w > b.w; });
        for (int64_t i = s; i < e; i++)
            out[i] = v[static_cast<size_t>(i - s)].idx;
    }
    return 0;
}

}  // extern "C"
