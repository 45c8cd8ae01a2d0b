// Cell-sorted fixed-radius neighbour count for Hopper (sm_90a).
//
// Replaces XLA code, not a Pallas kernel: smart_tree_tpu/neighbors/knn.py::
// radius_count (:256; the tiled scan of _radius_count_impl, :176), which
// counts N^2 pairs in the |s|^2 + |d|^2 - 2 s.d form for the outlier filter.
// Here, for each query q of the list `order`:
//
//   certain[q]  = min(cap, #{j : d2(q, j) < lo2[q]})
//   possible[q] = min(cap, #{j : d2(q, j) < hi2[q]})
//
// over the dst points sorted by cell (keys, pts), d2 = (dx*dx + dy*dy) + dz*dz
// with dx = src - dst, each operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), the order and the bits of the
// plain version in neighbors/grid_count.py. The thresholds, the reach and the
// grid come from there too; this kernel only scans.
//
// What bounds it. The count must read each query's point, radius and mask
// and write its two counts: 25 bytes a point when the queries are the dst
// points (the filter's only case), 7.5 us at 3.35 TB/s for a million points.
// The work depends on the data: with the filter's cap of 8
// and clouds as dense as a scan's (hundreds of points within a radius), a
// query stops after the first few points of its own column; a row that is an
// outlier reads every point of its range. The binary searches and the
// scattered reads of points are latency, not bandwidth; neighbouring threads
// take neighbouring cells (the wrapper orders the queries by cell), so a
// warp's reads share cache lines and the 50 MB L2 holds the keys.
//
// Design. One thread a query. The query's cell range on each axis is
// floor((p -+ R - o) / h), computed with the same rounded operations as the
// cells of the dst points and clamped to the grid as floats before any
// integer conversion (an infinite reach becomes the whole grid). Columns
// are visited in rings of growing Chebyshev distance around the query's own
// column, so a count that reaches `cap` stops near the query even when its
// range is the whole grid; a column's z run is one range of the sorted
// keys, found with two binary searches. Once `certain` reaches `cap`,
// `possible` (>= certain) is `cap` too, so the saturated outputs are the
// plain version's full counts clamped. A query with a NaN threshold
// (invalid row, NaN radius, non-finite point) writes zeros without a scan.
//
// Counts are integers summed one by one (no atomics): two launches give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// first index in keys[0, m) whose key is >= k
__device__ __forceinline__ int lower_bound(const long long* __restrict__ keys, int m,
                                           long long k) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float cell_of(float x, float o, float h) {
  return floorf(__fdiv_rn(__fsub_rn(x, o), h));
}

// The query's cells on one axis, clamped to [0, g - 1]; false when the range
// misses the grid.
__device__ __forceinline__ bool cell_range(float p, float r, float o, float h, int g,
                                           int& lo, int& hi) {
  const float a = cell_of(__fsub_rn(p, r), o, h);
  const float b = cell_of(__fadd_rn(p, r), o, h);
  const float top = static_cast<float>(g - 1);
  if (!(b >= 0.f) || !(a <= top)) return false;
  lo = static_cast<int>(fmaxf(a, 0.f));
  hi = static_cast<int>(fminf(b, top));
  return true;
}

__global__ void __launch_bounds__(kThreads)
radius_count_kernel(const float* __restrict__ src, int n, const int* __restrict__ order,
                    const float* __restrict__ lo2, const float* __restrict__ hi2,
                    const float* __restrict__ reach, const long long* __restrict__ keys,
                    const float* __restrict__ pts, int m, float ox, float oy, float oz,
                    float h, int gx, int gy, int gz, int cap, int* __restrict__ certain,
                    int* __restrict__ possible) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int q = order[t];
  const float lo = lo2[q], hi = hi2[q];
  int c = 0, p = 0;
  int lx, hx, ly, hy, lz, hz;
  // offsets in size_t: 3 q passes 2^31 - 1 past 715,827,882 points
  const float* s = src + 3 * static_cast<size_t>(q);
  const float px = s[0], py = s[1], pz = s[2];
  const float r = reach[q];
  if (hi > 0.f && cell_range(px, r, ox, h, gx, lx, hx) && cell_range(py, r, oy, h, gy, ly, hy) &&
      cell_range(pz, r, oz, h, gz, lz, hz)) {
    // the query's own column, inside its range
    const int ocx = min(max(static_cast<int>(fminf(fmaxf(cell_of(px, ox, h), 0.f),
                                                   static_cast<float>(gx - 1))), lx), hx);
    const int ocy = min(max(static_cast<int>(fminf(fmaxf(cell_of(py, oy, h), 0.f),
                                                   static_cast<float>(gy - 1))), ly), hy);
    bool full = false;
    // scans one column's z run; true once certain reached cap
    auto visit = [&](int cx, int cy) {
      const long long base = (static_cast<long long>(cx) * gy + cy) * gz;
      const int a = lower_bound(keys, m, base + lz);
      const int b = a + lower_bound(keys + a, m - a, base + hz + 1);
      for (int j = a; j < b; ++j) {
        const float* d = pts + 3 * static_cast<size_t>(j);
        const float dx = __fsub_rn(px, __ldg(d));
        const float dy = __fsub_rn(py, __ldg(d + 1));
        const float dz = __fsub_rn(pz, __ldg(d + 2));
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        c += d2 < lo;
        p += d2 < hi;
        if (c >= cap) return true;
      }
      return false;
    };
    const int kmax = max(max(ocx - lx, hx - ocx), max(ocy - ly, hy - ocy));
    for (int k = 0; k <= kmax && !full; ++k) {
      const int x0 = ocx - k, x1 = ocx + k, y0 = ocy - k, y1 = ocy + k;
      for (int cx = max(x0, lx); cx <= min(x1, hx) && !full; ++cx) {
        if (cx == x0 || cx == x1) {          // an edge of the ring: its whole y span
          for (int cy = max(y0, ly); cy <= min(y1, hy) && !full; ++cy) full = visit(cx, cy);
        } else {                             // inside: the ring's two y ends
          if (y0 >= ly) full = visit(cx, y0);
          if (!full && y1 <= hy) full = visit(cx, y1);
        }
      }
    }
  }
  certain[q] = min(c, cap);
  possible[q] = min(p, cap);
}

}  // namespace

extern "C" {

// src [n, 3] fp32, order [n] int32 (a permutation of the queries), lo2 / hi2 /
// reach [n] fp32, keys [m] int64 sorted, pts [m, 3] fp32 in key order, the
// grid's fp32 origin and edge and its cells per axis (keys are
// (cx * gy + cy) * gz + cz), cap >= 1; certain / possible [n] int32. Returns
// the cudaError_t of the launch.
int st_radius_count(const void* src, int n, const void* order, const void* lo2,
                    const void* hi2, const void* reach, const void* keys, const void* pts,
                    int m, float ox, float oy, float oz, float h, int gx, int gy, int gz,
                    int cap, void* certain, void* possible, void* stream) {
  if (n <= 0 || m <= 0 || cap < 1 || !(h > 0.f) || gx <= 0 || gy <= 0 || gz <= 0)
    return (int)cudaErrorInvalidValue;
  radius_count_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), n, static_cast<const int*>(order),
      static_cast<const float*>(lo2), static_cast<const float*>(hi2),
      static_cast<const float*>(reach), static_cast<const long long*>(keys),
      static_cast<const float*>(pts), m, ox, oy, oz, h, gx, gy, gz, cap,
      static_cast<int*>(certain), static_cast<int*>(possible));
  return (int)cudaGetLastError();
}

}  // extern "C"
