// Native per-step sampling kernels for the data loader (a copy of the JAX
// package's native/sampling.cpp: the same draws for the same seed).
//
// nerfstudio's samplers are Python loops over torch.unique
// (models/gaussian_splatting.py:120-148). These run every training step on
// the host while the card is busy, so they must be cheap: one O(H*W)
// bucketing pass, then O(samples) draws with an xorshift PRNG.
//
// Build: g++ -O3 -shared -fPIC -o build/libsampling.so native/sampling.cpp
// ABI: plain C, consumed via ctypes (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct XorShift {
    uint64_t s;
    explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
    uint64_t next() {
        s ^= s << 13;
        s ^= s >> 7;
        s ^= s << 17;
        return s;
    }
    // unbiased-enough draw in [0, n)
    int64_t below(int64_t n) { return (int64_t)(next() % (uint64_t)n); }
};

}  // namespace

extern "C" {

// Bucket pixels by SAM mask id and sample same-mask pixel pairs plus
// distillation points, in one pass.
//
//   mask:       (h*w) int32, ids >= 0 are instances, -1 = background
//   pair_a/b:   (g*p*2) int32 out, row-major (group, pair, {row, col})
//   pair_valid: (g*p) uint8 out
//   group_valid:(g) uint8 out
//   points:     (s*2) int32 out
//   point_valid:(s) uint8 out
// Returns the number of distinct mask ids found (may exceed g).
int32_t sample_mask_batch(
    const int32_t* mask, int32_t h, int32_t w,
    int32_t g, int32_t p, int32_t s, uint64_t seed,
    int32_t* pair_a, int32_t* pair_b, uint8_t* pair_valid,
    uint8_t* group_valid, int32_t* points, uint8_t* point_valid) {
    const int64_t n = (int64_t)h * w;

    // pass 1: count ids (ids are small non-negative ints in practice)
    int32_t max_id = -1;
    for (int64_t i = 0; i < n; ++i)
        if (mask[i] > max_id) max_id = mask[i];

    std::memset(pair_valid, 0, (size_t)g * p);
    std::memset(group_valid, 0, (size_t)g);
    std::memset(point_valid, 0, (size_t)s);
    std::memset(pair_a, 0, (size_t)g * p * 2 * sizeof(int32_t));
    std::memset(pair_b, 0, (size_t)g * p * 2 * sizeof(int32_t));
    std::memset(points, 0, (size_t)s * 2 * sizeof(int32_t));
    if (max_id < 0) return 0;

    const int32_t n_ids = max_id + 1;
    std::vector<int64_t> counts(n_ids, 0);
    for (int64_t i = 0; i < n; ++i)
        if (mask[i] >= 0) ++counts[mask[i]];

    // bucket pixel linear indices by id (CSR layout)
    std::vector<int64_t> offsets(n_ids + 1, 0);
    for (int32_t k = 0; k < n_ids; ++k) offsets[k + 1] = offsets[k] + counts[k];
    std::vector<int64_t> bucket(offsets[n_ids]);
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t id = mask[i];
        if (id >= 0) bucket[cursor[id]++] = i;
    }

    // which ids are present (non-empty)
    std::vector<int32_t> present;
    for (int32_t k = 0; k < n_ids; ++k)
        if (counts[k] > 0) present.push_back(k);
    const int32_t found = (int32_t)present.size();
    if (found == 0) return 0;

    XorShift rng(seed);

    // choose up to g ids without replacement (partial Fisher-Yates)
    std::vector<int32_t> chosen(present);
    const int32_t n_groups = found < g ? found : g;
    for (int32_t i = 0; i < n_groups; ++i) {
        const int64_t j = i + rng.below((int64_t)chosen.size() - i);
        std::swap(chosen[i], chosen[j]);
    }

    // pairs: uniform with replacement within each chosen id (matches the
    // reference's randint-based pair sampler)
    for (int32_t gi = 0; gi < n_groups; ++gi) {
        const int32_t id = chosen[gi];
        const int64_t base = offsets[id], cnt = counts[id];
        if (cnt < 2) continue;
        group_valid[gi] = 1;
        for (int32_t pi = 0; pi < p; ++pi) {
            const int64_t ia = bucket[base + rng.below(cnt)];
            const int64_t ib = bucket[base + rng.below(cnt)];
            int32_t* pa = pair_a + ((int64_t)gi * p + pi) * 2;
            int32_t* pb = pair_b + ((int64_t)gi * p + pi) * 2;
            pa[0] = (int32_t)(ia / w);
            pa[1] = (int32_t)(ia % w);
            pb[0] = (int32_t)(ib / w);
            pb[1] = (int32_t)(ib % w);
            pair_valid[(int64_t)gi * p + pi] = 1;
        }
    }

    // distillation points: s split evenly over ALL present ids (reference
    // sampling_in_mask semantics, num_samples // num_ids each)
    const int32_t per = s / found > 0 ? s / found : 1;
    int32_t k = 0;
    for (int32_t fi = 0; fi < found && k < s; ++fi) {
        const int32_t id = present[fi];
        const int64_t base = offsets[id], cnt = counts[id];
        const int32_t take = (per < s - k) ? per : (s - k);
        for (int32_t t = 0; t < take; ++t, ++k) {
            const int64_t i = bucket[base + rng.below(cnt)];
            points[(int64_t)k * 2] = (int32_t)(i / w);
            points[(int64_t)k * 2 + 1] = (int32_t)(i % w);
            point_valid[k] = 1;
        }
    }
    return found;
}

}  // extern "C"
