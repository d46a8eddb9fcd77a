// Host-side broadphase: sweep-and-prune over AABBs.
//
// Role: the native replacement for the ODE C library's hash-space
// `space.collide` that the reference delegates broadphase to
// (lcp_physics/physics/world.py -> ode space; SURVEY.md §2.2).  The device
// step uses a masked all-pairs AABB test; this routine serves the host
// side (World.broadphase_pairs, scene-build pair pruning), where C beats
// interpreted Python by orders of magnitude.  The port's copy of
// csrc/broadphase.cpp, built by lcp_physics_tpu_torch/native.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// aabbs: n rows of [minx, miny, maxx, maxy] (float32).
// mask:  n bytes; pair (i, j) is reported only if mask[i] && mask[j]
//        (nullptr = all active).
// out:   capacity `cap` (i, j) int32 pairs, i < j.
// Returns the number of overlapping pairs found (may exceed cap; only the
// first cap pairs are written).
int64_t sap_pairs(const float* aabbs, int64_t n, const uint8_t* mask,
                  int32_t* out, int64_t cap) {
    std::vector<int32_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return aabbs[4 * a] < aabbs[4 * b];
    });

    int64_t count = 0;
    // Active list sweep along x; typical contact-rich scenes keep the
    // active set tiny, giving ~O(n log n + k).
    std::vector<int32_t> active;
    active.reserve(64);
    for (int64_t oi = 0; oi < n; ++oi) {
        int32_t i = order[oi];
        if (mask && !mask[i]) continue;
        float minx = aabbs[4 * i + 0];
        float miny = aabbs[4 * i + 1];
        float maxy = aabbs[4 * i + 3];
        // drop expired intervals
        size_t w = 0;
        for (size_t k = 0; k < active.size(); ++k) {
            int32_t j = active[k];
            if (aabbs[4 * j + 2] >= minx) active[w++] = j;
        }
        active.resize(w);
        for (size_t k = 0; k < active.size(); ++k) {
            int32_t j = active[k];
            if (aabbs[4 * j + 1] <= maxy && aabbs[4 * j + 3] >= miny) {
                if (count < cap) {
                    int32_t lo = i < j ? i : j, hi = i < j ? j : i;
                    out[2 * count] = lo;
                    out[2 * count + 1] = hi;
                }
                ++count;
            }
        }
        active.push_back(i);
    }
    return count;
}

// Convenience: AABBs from circle data (centers + radii).
void circle_aabbs(const float* centers, const float* radii, int64_t n,
                  float* out_aabbs) {
    for (int64_t i = 0; i < n; ++i) {
        float cx = centers[2 * i], cy = centers[2 * i + 1], r = radii[i];
        out_aabbs[4 * i + 0] = cx - r;
        out_aabbs[4 * i + 1] = cy - r;
        out_aabbs[4 * i + 2] = cx + r;
        out_aabbs[4 * i + 3] = cy + r;
    }
}

}  // extern "C"
