// Native host runtime of smart_tree_tpu_torch: the host side of the input
// pipeline (cloud -> crop -> voxel dedup -> padded buffers).
//
// The port's copy of smart_tree_tpu/native/st_native.cpp, same functions and
// results. numpy's np.unique(axis=0) lexsorts structured rows and costs
// seconds at multi-million-point scale; st_voxelize replaces it with an
// open-addressed hash dedup and one sort of the occupied cells. Plain C
// interface, bound with ctypes and compiled with g++ at first use by
// smart_tree_tpu_torch/native/__init__.py, which raises when the build fails.
//
// Contract: st_voxelize equals data/dataset.py::voxelize_host_plain —
// floor-quantise against `origin` (dividing, as numpy does, not multiplying
// by a reciprocal), keep the LOWEST original row per voxel, output voxels in
// lexicographic (x,y,z) order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cell {
    int32_t x, y, z;
    int64_t first;
};

inline uint64_t hash_cell(int32_t x, int32_t y, int32_t z) {
    uint64_t h = static_cast<uint32_t>(x) * 73856093ull;
    h ^= static_cast<uint32_t>(y) * 19349663ull;
    h ^= static_cast<uint32_t>(z) * 83492791ull;
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdull;
    h ^= h >> 33;
    return h;
}

}  // namespace

extern "C" {

// Voxel dedup: out_coords must hold n*3 int32, out_first n int64.
// Returns the number of occupied voxels (M), or -1 on error.
int64_t st_voxelize(const float* xyz, int64_t n, float voxel,
                    const float* origin, int32_t* out_coords,
                    int64_t* out_first) {
    if (n <= 0) return 0;
    // open-addressed hash table, power-of-two capacity >= 2n
    uint64_t cap = 1;
    while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slots(cap, -1);  // index into cells
    std::vector<Cell> cells;
    cells.reserve(n / 2 + 8);

    // divide (not multiply-by-reciprocal): bit-parity with numpy's
    // np.floor((xyz - origin) / voxel) at cell boundaries
    for (int64_t i = 0; i < n; ++i) {
        const int32_t gx =
            static_cast<int32_t>(std::floor((xyz[3 * i + 0] - origin[0]) / voxel));
        const int32_t gy =
            static_cast<int32_t>(std::floor((xyz[3 * i + 1] - origin[1]) / voxel));
        const int32_t gz =
            static_cast<int32_t>(std::floor((xyz[3 * i + 2] - origin[2]) / voxel));
        uint64_t h = hash_cell(gx, gy, gz) & mask;
        for (;;) {
            int64_t s = slots[h];
            if (s < 0) {
                slots[h] = static_cast<int64_t>(cells.size());
                cells.push_back({gx, gy, gz, i});
                break;
            }
            Cell& c = cells[s];
            if (c.x == gx && c.y == gy && c.z == gz) {
                if (i < c.first) c.first = i;  // lowest original row wins
                break;
            }
            h = (h + 1) & mask;
        }
    }
    // lexicographic output order (np.unique(axis=0) parity)
    std::sort(cells.begin(), cells.end(), [](const Cell& a, const Cell& b) {
        if (a.x != b.x) return a.x < b.x;
        if (a.y != b.y) return a.y < b.y;
        return a.z < b.z;
    });
    const int64_t m = static_cast<int64_t>(cells.size());
    for (int64_t j = 0; j < m; ++j) {
        out_coords[3 * j + 0] = cells[j].x;
        out_coords[3 * j + 1] = cells[j].y;
        out_coords[3 * j + 2] = cells[j].z;
        out_first[j] = cells[j].first;
    }
    return m;
}

// AABB cube mask (utils/maths.py::cube_filter parity: [min, max) half-open).
// out_mask: n uint8. Returns count inside.
int64_t st_cube_filter(const float* xyz, int64_t n, const float* centre,
                       float size, uint8_t* out_mask) {
    const float hx0 = centre[0] - size / 2, hx1 = centre[0] + size / 2;
    const float hy0 = centre[1] - size / 2, hy1 = centre[1] + size / 2;
    const float hz0 = centre[2] - size / 2, hz1 = centre[2] + size / 2;
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        const uint8_t in = (x >= hx0 && x < hx1 && y >= hy0 && y < hy1 &&
                            z >= hz0 && z < hz1)
                               ? 1
                               : 0;
        out_mask[i] = in;
        count += in;
    }
    return count;
}

// Block occupancy: floor-div block ids + per-block counts via hashing.
// out_ids: n int64 (dense block index per point, assigned in first-seen
// order); out_block_coords: capacity n*3 int32; returns number of blocks.
int64_t st_block_ids(const float* xyz, int64_t n, float block_size,
                     int64_t* out_ids, int32_t* out_block_coords) {
    if (n <= 0) return 0;
    uint64_t cap = 1;
    while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slots(cap, -1);
    std::vector<Cell> cells;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t gx = static_cast<int32_t>(std::floor(xyz[3 * i] / block_size));
        const int32_t gy = static_cast<int32_t>(std::floor(xyz[3 * i + 1] / block_size));
        const int32_t gz = static_cast<int32_t>(std::floor(xyz[3 * i + 2] / block_size));
        uint64_t h = hash_cell(gx, gy, gz) & mask;
        for (;;) {
            int64_t s = slots[h];
            if (s < 0) {
                slots[h] = static_cast<int64_t>(cells.size());
                out_ids[i] = static_cast<int64_t>(cells.size());
                cells.push_back({gx, gy, gz, i});
                break;
            }
            const Cell& c = cells[s];
            if (c.x == gx && c.y == gy && c.z == gz) {
                out_ids[i] = s;
                break;
            }
            h = (h + 1) & mask;
        }
    }
    for (size_t j = 0; j < cells.size(); ++j) {
        out_block_coords[3 * j + 0] = cells[j].x;
        out_block_coords[3 * j + 1] = cells[j].y;
        out_block_coords[3 * j + 2] = cells[j].z;
    }
    return static_cast<int64_t>(cells.size());
}

}  // extern "C"
