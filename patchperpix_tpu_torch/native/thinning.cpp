// Topology-preserving 3D/2D thinning (medial skeleton).
//
// The port's copy of patchperpix_tpu/native/thinning.cpp, the native
// counterpart of utils/skeleton.py (which replaces
// skimage.morphology.skeletonize_3d used by the reference at
// vote_instances.py:221-224 and for clDice evaluation): 6 border-direction
// subiterations delete simple points (deletion preserves the foreground
// 26-component and background 6-component counts in the 3^3 neighborhood),
// keeping curve endpoints.  Simple-point decisions depend only on the
// 26-bit neighbor configuration and are memoized in a lazy bitmap.
//
// Exposed as a C ABI for ctypes (patchperpix_tpu_torch/native/__init__.py
// builds it with g++); utils/skeleton.py's Python thinning, reached only by
// an explicit native=False, has identical semantics.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- 3D simple point test (memoized over 2^26 configurations) ----------

// neighbor order: linear index over the 3x3x3 box skipping the center.
inline int bit_index(int dz, int dy, int dx) {
    int i = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1);
    return i < 13 ? i : i - 1;  // skip center (13)
}

struct LUT {
    std::vector<uint8_t> value;     // 1 bit would do; byte keeps it simple
    std::vector<uint8_t> computed;
    LUT() : value(1u << 26, 0), computed(1u << 26, 0) {}
};

bool compute_simple_3d(uint32_t cfg) {
    // local 3x3x3 occupancy, center set
    bool occ[27];
    for (int i = 0; i < 27; ++i) occ[i] = false;
    occ[13] = true;
    for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
                if (!dz && !dy && !dx) continue;
                if (cfg >> bit_index(dz, dy, dx) & 1u)
                    occ[(dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)] = true;
            }

    // (a) exactly one 26-connected fg component among the 26 neighbors
    {
        bool visited[27] = {false};
        int comps = 0;
        for (int s = 0; s < 27; ++s) {
            if (s == 13 || !occ[s] || visited[s]) continue;
            ++comps;
            if (comps > 1) return false;
            int stack[27], top = 0;
            stack[top++] = s;
            visited[s] = true;
            while (top) {
                int v = stack[--top];
                int vz = v / 9, vy = (v % 9) / 3, vx = v % 3;
                for (int dz = -1; dz <= 1; ++dz)
                    for (int dy = -1; dy <= 1; ++dy)
                        for (int dx = -1; dx <= 1; ++dx) {
                            int nz = vz + dz, ny = vy + dy, nx = vx + dx;
                            if (nz < 0 || nz > 2 || ny < 0 || ny > 2 ||
                                nx < 0 || nx > 2)
                                continue;
                            int n = nz * 9 + ny * 3 + nx;
                            if (n == 13 || !occ[n] || visited[n]) continue;
                            visited[n] = true;
                            stack[top++] = n;
                        }
            }
        }
        if (comps != 1) return false;
    }

    // (b) exactly one 6-connected bg component within the 18-neighborhood
    // that is 6-adjacent to the center
    {
        // 18-neighborhood: |dz|+|dy|+|dx| <= 2 excluding center
        auto in18 = [](int z, int y, int x) {
            int a = z != 1, b = y != 1, c = x != 1;
            return (a + b + c) > 0 && (a + b + c) <= 2;
        };
        bool bg[27];
        for (int z = 0; z < 3; ++z)
            for (int y = 0; y < 3; ++y)
                for (int x = 0; x < 3; ++x) {
                    int i = z * 9 + y * 3 + x;
                    bg[i] = in18(z, y, x) && !occ[i];
                }
        int comp_of[27];
        for (int i = 0; i < 27; ++i) comp_of[i] = -1;
        int comps = 0;
        const int d6[6][3] = {{1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                              {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};
        for (int s = 0; s < 27; ++s) {
            if (!bg[s] || comp_of[s] >= 0) continue;
            int id = comps++;
            int stack[27], top = 0;
            stack[top++] = s;
            comp_of[s] = id;
            while (top) {
                int v = stack[--top];
                int vz = v / 9, vy = (v % 9) / 3, vx = v % 3;
                for (auto &d : d6) {
                    int nz = vz + d[0], ny = vy + d[1], nx = vx + d[2];
                    if (nz < 0 || nz > 2 || ny < 0 || ny > 2 || nx < 0 ||
                        nx > 2)
                        continue;
                    int n = nz * 9 + ny * 3 + nx;
                    if (!bg[n] || comp_of[n] >= 0) continue;
                    comp_of[n] = id;
                    stack[top++] = n;
                }
            }
        }
        // 6-adjacent-to-center bg components
        bool adj[32] = {false};
        int n_adj = 0;
        const int faces[6] = {4, 22, 10, 16, 12, 14};
        for (int f : faces) {
            int c = comp_of[f];
            if (c >= 0 && !adj[c]) {
                adj[c] = true;
                ++n_adj;
            }
        }
        if (n_adj != 1) return false;
    }
    return true;
}

LUT *g_lut = nullptr;

inline bool is_simple_3d(uint32_t cfg) {
    if (!g_lut) g_lut = new LUT();
    if (!g_lut->computed[cfg]) {
        g_lut->value[cfg] = compute_simple_3d(cfg) ? 1 : 0;
        g_lut->computed[cfg] = 1;
    }
    return g_lut->value[cfg] != 0;
}

}  // namespace

extern "C" {

// In-place thinning of a (nz, ny, nx) uint8 volume (0/1).  Returns the
// number of removed voxels.  2D inputs pass nz == 1 (handled by the same
// code; dz offsets out of range are background).
long long ppp_skeletonize_3d(uint8_t *vol, long long nz, long long ny,
                             long long nx) {
    const long long sy = nx, sz = ny * nx;
    auto at = [&](long long z, long long y, long long x) -> uint8_t & {
        return vol[z * sz + y * sy + x];
    };
    auto get = [&](long long z, long long y, long long x) -> bool {
        if (z < 0 || z >= nz || y < 0 || y >= ny || x < 0 || x >= nx)
            return false;
        return at(z, y, x) != 0;
    };
    auto config = [&](long long z, long long y, long long x) -> uint32_t {
        uint32_t cfg = 0;
        for (int dz = -1; dz <= 1; ++dz)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dx = -1; dx <= 1; ++dx) {
                    if (!dz && !dy && !dx) continue;
                    if (get(z + dz, y + dy, x + dx))
                        cfg |= 1u << bit_index(dz, dy, dx);
                }
        return cfg;
    };
    auto popcount26 = [](uint32_t cfg) {
        return __builtin_popcount(cfg);
    };

    const int dirs[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                            {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};

    long long removed_total = 0;
    std::vector<long long> cand;
    bool changed = true;
    while (changed) {
        changed = false;
        for (auto &d : dirs) {
            // skip z directions for flat volumes (matches the 2D python
            // path which only uses in-plane borders)
            if (nz == 1 && d[0] != 0) continue;
            cand.clear();
            for (long long z = 0; z < nz; ++z)
                for (long long y = 0; y < ny; ++y)
                    for (long long x = 0; x < nx; ++x) {
                        if (!at(z, y, x)) continue;
                        if (get(z + d[0], y + d[1], x + d[2])) continue;
                        cand.push_back(z * sz + y * sy + x);
                    }
            for (long long idx : cand) {
                long long z = idx / sz, y = (idx % sz) / sy, x = idx % sy;
                if (!at(z, y, x)) continue;
                uint32_t cfg = config(z, y, x);
                int nb = popcount26(cfg);
                if (nb <= 1) continue;  // endpoint
                if (!is_simple_3d(cfg)) continue;
                at(z, y, x) = 0;
                ++removed_total;
                changed = true;
            }
        }
    }
    return removed_total;
}

}  // extern "C"

// ---- 2D thinning (8-connectivity fg / 4-connectivity bg) ----------------
//
// Exact counterpart of skeleton.py's _is_simple_2d/_thin 2D path (the
// python fallback used for BBBC010-style 2D evaluation): the 8-bit
// neighbor configuration is fully enumerable, so the LUT is precomputed.

namespace {

inline int bit_index_2d(int dy, int dx) {
    int i = (dy + 1) * 3 + (dx + 1);
    return i < 4 ? i : i - 1;  // skip center (4)
}

bool compute_simple_2d(uint32_t cfg) {
    bool occ[9];
    for (int i = 0; i < 9; ++i) occ[i] = false;
    occ[4] = true;
    for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
            if (!dy && !dx) continue;
            if (cfg >> bit_index_2d(dy, dx) & 1u)
                occ[(dy + 1) * 3 + (dx + 1)] = true;
        }

    // (a) exactly one 8-connected fg component among the 8 neighbors
    {
        bool visited[9] = {false};
        int comps = 0;
        for (int s = 0; s < 9; ++s) {
            if (s == 4 || !occ[s] || visited[s]) continue;
            ++comps;
            if (comps > 1) return false;
            int stack[9], top = 0;
            stack[top++] = s;
            visited[s] = true;
            while (top) {
                int v = stack[--top];
                int vy = v / 3, vx = v % 3;
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dx = -1; dx <= 1; ++dx) {
                        int ny2 = vy + dy, nx2 = vx + dx;
                        if (ny2 < 0 || ny2 > 2 || nx2 < 0 || nx2 > 2)
                            continue;
                        int n = ny2 * 3 + nx2;
                        if (n == 4 || !occ[n] || visited[n]) continue;
                        visited[n] = true;
                        stack[top++] = n;
                    }
            }
        }
        if (comps != 1) return false;
    }

    // (b) exactly one 4-connected bg component (over the full 3x3)
    // 4-adjacent to the center
    {
        bool bg[9];
        for (int i = 0; i < 9; ++i) bg[i] = !occ[i];
        int comp_of[9];
        for (int i = 0; i < 9; ++i) comp_of[i] = -1;
        int comps = 0;
        const int d4[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
        for (int s = 0; s < 9; ++s) {
            if (!bg[s] || comp_of[s] >= 0) continue;
            int id = comps++;
            int stack[9], top = 0;
            stack[top++] = s;
            comp_of[s] = id;
            while (top) {
                int v = stack[--top];
                int vy = v / 3, vx = v % 3;
                for (auto &d : d4) {
                    int ny2 = vy + d[0], nx2 = vx + d[1];
                    if (ny2 < 0 || ny2 > 2 || nx2 < 0 || nx2 > 2) continue;
                    int n = ny2 * 3 + nx2;
                    if (!bg[n] || comp_of[n] >= 0) continue;
                    comp_of[n] = id;
                    stack[top++] = n;
                }
            }
        }
        bool adj[16] = {false};
        int n_adj = 0;
        const int edges[4] = {1, 7, 3, 5};  // N, S, W, E of center
        for (int e : edges) {
            int c = comp_of[e];
            if (c >= 0 && !adj[c]) {
                adj[c] = true;
                ++n_adj;
            }
        }
        if (n_adj != 1) return false;
    }
    return true;
}

uint8_t g_lut2d[256];
bool g_lut2d_ready = false;

inline bool is_simple_2d(uint32_t cfg) {
    if (!g_lut2d_ready) {
        for (uint32_t c = 0; c < 256; ++c)
            g_lut2d[c] = compute_simple_2d(c) ? 1 : 0;
        g_lut2d_ready = true;
    }
    return g_lut2d[cfg] != 0;
}

}  // namespace

extern "C" {

// In-place thinning of an (ny, nx) uint8 image (0/1); returns removals.
long long ppp_skeletonize_2d(uint8_t *img, long long ny, long long nx) {
    auto at = [&](long long y, long long x) -> uint8_t & {
        return img[y * nx + x];
    };
    auto get = [&](long long y, long long x) -> bool {
        if (y < 0 || y >= ny || x < 0 || x >= nx) return false;
        return at(y, x) != 0;
    };
    auto config = [&](long long y, long long x) -> uint32_t {
        uint32_t cfg = 0;
        for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
                if (!dy && !dx) continue;
                if (get(y + dy, x + dx))
                    cfg |= 1u << bit_index_2d(dy, dx);
            }
        return cfg;
    };

    const int dirs[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
    long long removed_total = 0;
    std::vector<long long> cand;
    bool changed = true;
    while (changed) {
        changed = false;
        for (auto &d : dirs) {
            cand.clear();
            for (long long y = 0; y < ny; ++y)
                for (long long x = 0; x < nx; ++x) {
                    if (!at(y, x)) continue;
                    if (get(y + d[0], x + d[1])) continue;
                    cand.push_back(y * nx + x);
                }
            for (long long idx : cand) {
                long long y = idx / nx, x = idx % nx;
                if (!at(y, x)) continue;
                uint32_t cfg = config(y, x);
                if (__builtin_popcount(cfg) <= 1) continue;  // endpoint
                if (!is_simple_2d(cfg)) continue;
                at(y, x) = 0;
                ++removed_total;
                changed = true;
            }
        }
    }
    return removed_total;
}

}  // extern "C"
