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

// Halo binning of data/dataset.py::BlockTiler: for each kept block (ids: nb
// x 3 int64 block coordinates, in the tiler's order) the rows of the points
// inside its buffered cube, in ascending order, and whether each lies inside
// the un-buffered cube. Membership is native.tile_blocks_plain's (a
// utils/maths.py::cube_filter per block): the float32 point against float64
// faces, half-open, with
//   centre = id * block + block / 2,
//   halo faces = centre -+ (block + 2 * buffer) / 2,
//   interior faces = centre -+ block / 2,
// each rounded as numpy rounds it (the library is built with
// -ffp-contract=off, so no multiply-add is fused).
//
// The box test is an AND of one test per axis, and an axis' faces depend only
// on the block's coordinate on that axis. So per point and axis the blocks
// whose slab holds it are found exactly among the point's own cell
// floor(p / block) and `reach` cells either side (reach = floor(|buffer| /
// block) + 1, so any buffer stays covered), and each combination of the three
// axes' blocks is one point-box test: a lookup among the kept blocks.
//
// Called twice. With out_rows null it counts: out_offsets (nb + 1 int64)
// gets each block's first row, *out_tests the point-box tests made. Then,
// given those offsets, out_rows (int64) and out_interior (uint8) are filled.
// Returns the number of rows, -1 when a block id repeats, -2 on bad sizes.
int64_t st_tile_blocks(const float* xyz, int64_t n, const int64_t* ids,
                       int64_t nb, double block, double buffer,
                       int64_t* out_offsets, int64_t* out_rows,
                       uint8_t* out_interior, int64_t* out_tests) {
    if (n < 0 || nb < 0 || !(block > 0.0)) return -2;
    const bool fill = out_rows != nullptr;
    if (!fill) std::fill(out_offsets, out_offsets + nb + 1, int64_t{0});
    if (nb == 0 || n == 0) {
        if (!fill) *out_tests = 0;
        return 0;
    }
    // kept-block lookup: open-addressed, power-of-two capacity >= 4 nb
    uint64_t cap = 1;
    while (cap < static_cast<uint64_t>(4 * nb)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<int64_t> slots(cap, -1);
    auto probe = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
        uint64_t h = hash_cell(static_cast<int32_t>(x), static_cast<int32_t>(y),
                               static_cast<int32_t>(z)) &
                     mask;
        for (;;) {
            const int64_t s = slots[h];
            if (s < 0 || (ids[3 * s] == x && ids[3 * s + 1] == y &&
                          ids[3 * s + 2] == z))
                return h;
            h = (h + 1) & mask;
        }
    };
    for (int64_t j = 0; j < nb; ++j) {
        const uint64_t h = probe(ids[3 * j], ids[3 * j + 1], ids[3 * j + 2]);
        if (slots[h] >= 0) return -1;
        slots[h] = j;
    }

    const double half_halo = (block + 2.0 * buffer) / 2.0;
    const double half_in = block / 2.0;
    const int64_t reach = static_cast<int64_t>(std::floor(std::fabs(buffer) / block)) + 1;
    // per axis: the blocks whose buffered slab holds the point, and whether
    // its un-buffered slab does
    std::vector<int64_t> hit[3];
    std::vector<uint8_t> inside[3];
    for (int a = 0; a < 3; ++a) {
        hit[a].reserve(2 * reach + 1);
        inside[a].reserve(2 * reach + 1);
    }
    std::vector<int64_t> cursor;
    if (fill) cursor.assign(out_offsets, out_offsets + nb);
    int64_t tests = 0;
    for (int64_t i = 0; i < n; ++i) {
        bool any = true;
        for (int a = 0; a < 3 && any; ++a) {
            const double p = static_cast<double>(xyz[3 * i + a]);
            hit[a].clear();
            inside[a].clear();
            if (!std::isfinite(p)) {  // cube_filter's comparisons are false
                any = false;
                continue;
            }
            const int64_t c = static_cast<int64_t>(std::floor(p / block));
            for (int64_t k = c - reach; k <= c + reach; ++k) {
                const double centre = static_cast<double>(k) * block + block / 2.0;
                if (centre - half_halo <= p && p < centre + half_halo) {
                    hit[a].push_back(k);
                    inside[a].push_back(centre - half_in <= p && p < centre + half_in);
                }
            }
            any = !hit[a].empty();
        }
        if (!any) continue;
        for (size_t ix = 0; ix < hit[0].size(); ++ix)
            for (size_t iy = 0; iy < hit[1].size(); ++iy)
                for (size_t iz = 0; iz < hit[2].size(); ++iz) {
                    ++tests;
                    const int64_t j = slots[probe(hit[0][ix], hit[1][iy], hit[2][iz])];
                    if (j < 0) continue;
                    if (!fill) {
                        ++out_offsets[j + 1];
                        continue;
                    }
                    const int64_t r = cursor[j]++;
                    out_rows[r] = i;
                    out_interior[r] = inside[0][ix] & inside[1][iy] & inside[2][iz];
                }
    }
    if (!fill) {
        for (int64_t j = 0; j < nb; ++j) out_offsets[j + 1] += out_offsets[j];
        *out_tests = tests;
    }
    return out_offsets[nb];
}

}  // extern "C"
