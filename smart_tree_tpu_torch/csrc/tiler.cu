// Block tiling of a cloud on Hopper (sm_90a): halo binning, voxel dedup
// and key order, then one gather a batch into ModelInference.forward's
// sorted input.
//
// Replaces no Pallas kernel: the JAX package tiles on the host
// (smart_tree_tpu/data/dataset.py BlockTiler, its native dedup). The port
// did the same, one core walking every point and every halo row
// (data/dataset.py::BlockTiler with native.tile_blocks and a native dedup a
// block, then VoxelBatch.key_order and _stage_sorted a batch) while the card
// sat idle. Here the card does that work and the host reads two headers a
// cloud; core/tiler.py is the wrapper and holds the plain version.
//
// Per cloud, with B kept blocks (lexicographic block ids), a grid of side S
// and slabs s = b * S + x (a block's voxels of one x):
//
//   1. bin: a point's blocks are those whose buffered cube holds it, found
//      per axis among the `reach` cells either side of its own, with the
//      float64 faces and the point-box tests of native.tile_blocks; each
//      block's origin is the float32 minimum of its halo points (an atomic
//      minimum), and the point-box tests and halo rows are counted.
//   2. slab_count / scan / slab_fill: every halo row's voxel, floor((p -
//      origin) / voxel) in float32, counted and then placed by slab.
//   3. slab_sort (one CTA a slab): the slab's rows counted by y and placed by
//      column in shared memory, then in each (y) column the row of the
//      lowest point index of each z is kept (the dedup) and ranked among the
//      kept ones by z, so a kept row's rank in the slab is its voxel's rank
//      in lexicographic order.
//   4. scan / slab_emit: the slabs' voxel counts scanned, each kept row
//      written at its voxel's place: the packed (x, y, z) key, the point
//      index and whether the point is interior; a block's voxel count and
//      interior count go to the header the host reads.
//
// Per batch, gather writes the rows of its blocks in slot order, which is
// key order since a key carries its slot in the top bits: the int64 key,
// the residual from the voxel centre taken in float64 (int8 steps of
// voxel / 254, or fp16), the interior flag, the point index, and the batch's
// origins.
//
// Every float operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts no multiply-add and the faces, voxels and residuals round as the
// host's numpy and g++ -ffp-contract=off code does.
//
// What bounds it: bytes and atomics, not operations. A cloud's points are
// read three times (12 B each), its halo rows written and read about four
// times (8 B each); the slab kernels' column scans are O(c^2) in the rows c
// of a (block, x, y) column, a few to a few dozen in a tree scan.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxSide = 1024;     // a key has at most 10 bits an axis
constexpr int kMaxWindow = 31;     // 2 * reach + 1 cells an axis, in a uint32 mask

// header slots (int64), in core/tiler.py's order
constexpr int kTests = 0;     // point-box tests
constexpr int kHalo = 1;      // halo rows
constexpr int kBad = 2;       // halo rows whose voxel falls outside the grid
constexpr int kCounts = 3;    // then B voxel counts, then B interior counts

constexpr uint32_t kInterior = 1u << 30;
constexpr uint32_t kLeader = 1u << 31;

struct Faces {
  double block, half_block, half_halo, half_in;
  int reach;
};

// The blocks whose buffered slab holds p on one axis, as a mask over the
// cells c - reach .. c + reach (c = floor(p / block)), and those whose
// un-buffered slab does. False for a non-finite p (cube_filter's
// comparisons are false).
__device__ __forceinline__ bool axis_hits(float pf, const Faces& f, long long* c,
                                          uint32_t* hit, uint32_t* inside) {
  const double p = static_cast<double>(pf);
  *hit = 0u;
  *inside = 0u;
  if (!isfinite(p)) return false;
  *c = static_cast<long long>(floor(__ddiv_rn(p, f.block)));
  for (int d = 0; d <= 2 * f.reach; ++d) {
    const long long k = *c - f.reach + d;
    const double centre = __dadd_rn(__dmul_rn(static_cast<double>(k), f.block), f.half_block);
    if (__dsub_rn(centre, f.half_halo) <= p && p < __dadd_rn(centre, f.half_halo)) {
      *hit |= 1u << d;
      if (__dsub_rn(centre, f.half_in) <= p && p < __dadd_rn(centre, f.half_in))
        *inside |= 1u << d;
    }
  }
  return *hit != 0u;
}

// The kept block with coordinates (x, y, z), or -1: a binary search of the
// lexicographically sorted ids.
__device__ __forceinline__ int find_block(const long long* __restrict__ ids, int nb,
                                          long long x, long long y, long long z) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const long long a = ids[3 * mid], b = ids[3 * mid + 1], c = ids[3 * mid + 2];
    const bool less = a < x || (a == x && (b < y || (b == y && c < z)));
    if (less) lo = mid + 1; else hi = mid;
  }
  if (lo < nb && ids[3 * lo] == x && ids[3 * lo + 1] == y && ids[3 * lo + 2] == z) return lo;
  return -1;
}

// The float32 minimum as an atomic on its bits (+inf to start): a
// non-negative float orders as its int bits, a negative one reversed as its
// unsigned bits. The first read skips the atomic where the stored minimum
// (which only falls) is already no larger.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (__ldcg(addr) <= v) return;
  if (v >= 0.f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void warp_add(unsigned long long* addr, unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(addr, v);
}

// A point's kept blocks: calls visit(j, interior) for each, returns the
// point-box tests made (every combination of the axes' hits).
template <typename Visit>
__device__ __forceinline__ int for_each_block(const float* __restrict__ xyz, long long i,
                                              const long long* __restrict__ ids, int nb,
                                              const Faces& f, Visit visit) {
  long long c[3];
  uint32_t hit[3], inside[3];
  for (int a = 0; a < 3; ++a)
    if (!axis_hits(xyz[3 * i + a], f, &c[a], &hit[a], &inside[a])) return 0;
  int tests = 0;
  for (uint32_t mx = hit[0]; mx; mx &= mx - 1) {
    const int dx = __ffs(mx) - 1;
    for (uint32_t my = hit[1]; my; my &= my - 1) {
      const int dy = __ffs(my) - 1;
      for (uint32_t mz = hit[2]; mz; mz &= mz - 1) {
        const int dz = __ffs(mz) - 1;
        ++tests;
        const int j = find_block(ids, nb, c[0] - f.reach + dx, c[1] - f.reach + dy,
                                 c[2] - f.reach + dz);
        if (j >= 0)
          visit(j, ((inside[0] >> dx) & (inside[1] >> dy) & (inside[2] >> dz) & 1u) != 0u);
      }
    }
  }
  return tests;
}

// A halo row's voxel in its block's grid, floor((p - origin) / voxel) in
// float32; false (and counted) outside [0, side).
__device__ __forceinline__ bool voxel_of(const float* __restrict__ xyz, long long i,
                                         const float* __restrict__ origin, int j, float voxel,
                                         int side, int g[3]) {
  bool ok = true;
  for (int a = 0; a < 3; ++a) {
    const float q = floorf(__fdiv_rn(__fsub_rn(xyz[3 * i + a], origin[3 * j + a]), voxel));
    ok = ok && q >= 0.f && q < static_cast<float>(side);
    g[a] = ok ? static_cast<int>(q) : 0;
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
tiler_bin(const float* __restrict__ xyz, long long n, const long long* __restrict__ ids, int nb,
           Faces f, float* __restrict__ origin, unsigned long long* __restrict__ hdr) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  unsigned long long tests = 0, rows = 0;
  if (i < n) {
    tests = for_each_block(xyz, i, ids, nb, f, [&](int j, bool) {
      ++rows;
      for (int a = 0; a < 3; ++a) atomic_min_float(&origin[3 * j + a], xyz[3 * i + a]);
    });
  }
  warp_add(&hdr[kTests], tests);
  warp_add(&hdr[kHalo], rows);
}

__global__ void __launch_bounds__(kThreads)
tiler_slab_count(const float* __restrict__ xyz, long long n, const long long* __restrict__ ids,
                  int nb, Faces f, const float* __restrict__ origin, float voxel, int side,
                  unsigned int* __restrict__ count, unsigned long long* __restrict__ hdr) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  unsigned long long bad = 0;
  if (i < n) {
    for_each_block(xyz, i, ids, nb, f, [&](int j, bool) {
      int g[3];
      if (voxel_of(xyz, i, origin, j, voxel, side, g))
        atomicAdd(&count[static_cast<long long>(j) * side + g[0]], 1u);
      else
        ++bad;
    });
  }
  warp_add(&hdr[kBad], bad);
}

// count[s] holds the rows still to place in slab s: each row takes the slot
// start[s] + count[s] - 1 as it decrements it, so count ends at zero.
__global__ void __launch_bounds__(kThreads)
tiler_slab_fill(const float* __restrict__ xyz, long long n, const long long* __restrict__ ids,
                 int nb, Faces f, const float* __restrict__ origin, float voxel, int side,
                 int bits, const unsigned int* __restrict__ start, unsigned int* __restrict__ count,
                 uint2* __restrict__ rec) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= n) return;
  for_each_block(xyz, i, ids, nb, f, [&](int j, bool interior) {
    int g[3];
    if (!voxel_of(xyz, i, origin, j, voxel, side, g)) return;
    const long long s = static_cast<long long>(j) * side + g[0];
    const unsigned int at = start[s] + atomicSub(&count[s], 1u) - 1u;
    const uint32_t yz = (static_cast<uint32_t>(g[1]) << bits) | static_cast<uint32_t>(g[2]);
    rec[at] = make_uint2(yz | (interior ? kInterior : 0u), static_cast<uint32_t>(i));
  });
}

// Exclusive scan of one CTA's shared array a[0 .. 1024) in place (256
// threads, four entries each); returns the total to every thread.
__device__ unsigned int scan_1024(unsigned int* a, unsigned int* warp_sums) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned int v[4], sum = 0;
  for (int k = 0; k < 4; ++k) {
    v[k] = a[4 * t + k];
    sum += v[k];
  }
  unsigned int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (t == 0) {
    unsigned int run = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const unsigned int s = warp_sums[w];
      warp_sums[w] = run;
      run += s;
    }
    warp_sums[kThreads / 32] = run;
  }
  __syncthreads();
  unsigned int run = warp_sums[warp] + incl - sum;
  for (int k = 0; k < 4; ++k) {
    a[4 * t + k] = run;
    run += v[k];
  }
  const unsigned int total = warp_sums[kThreads / 32];
  __syncthreads();
  return total;
}

// Exclusive scan of n counts into start[0 .. n] in one CTA: each thread
// sums a contiguous run, the runs' sums are scanned, then each run is
// written.
__global__ void __launch_bounds__(kScanThreads)
tiler_scan(const unsigned int* __restrict__ in, long long n, unsigned int* __restrict__ out) {
  __shared__ unsigned int sums[kScanThreads];
  const int t = threadIdx.x;
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = min(n, t * per), hi = min(n, lo + per);
  unsigned int sum = 0;
  for (long long k = lo; k < hi; ++k) sum += in[k];
  sums[t] = sum;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const unsigned int up = t >= o ? sums[t - o] : 0u;
    __syncthreads();
    sums[t] += up;
    __syncthreads();
  }
  unsigned int run = sums[t] - sum;
  for (long long k = lo; k < hi; ++k) {
    out[k] = run;
    run += in[k];
  }
  if (t == kScanThreads - 1) out[n] = sums[t];
}

// One CTA a slab (block j, x): the rows placed by y column, each column's
// lowest point index of each z kept, and each kept row ranked in the slab
// (rank[]; -1 for the rows the dedup drops). ucount[s] gets the slab's
// voxels, hdr's interior count of block j its interior ones.
__global__ void __launch_bounds__(kThreads)
tiler_slab_sort(const unsigned int* __restrict__ start, const uint2* __restrict__ rec,
                 uint2* tmp, int* rank, unsigned int* __restrict__ ucount, int side, int bits,
                 int nb, unsigned long long* __restrict__ hdr) {
  __shared__ unsigned int cnt[kMaxSide], cur[kMaxSide], ucnt[kMaxSide];
  __shared__ unsigned int warp_sums[kThreads / 32 + 1];
  __shared__ unsigned int interior_total;
  const long long s = blockIdx.x;
  const unsigned int base = start[s];
  const int n = static_cast<int>(start[s + 1] - base);
  const int t = threadIdx.x;
  if (n == 0) {
    if (t == 0) ucount[s] = 0u;
    return;
  }
  const uint32_t mask = (1u << bits) - 1u;
  for (int y = t; y < kMaxSide; y += kThreads) {
    cnt[y] = 0u;
    ucnt[y] = 0u;
  }
  if (t == 0) interior_total = 0u;
  __syncthreads();
  for (int q = t; q < n; q += kThreads) atomicAdd(&cnt[(rec[base + q].x >> bits) & mask], 1u);
  __syncthreads();
  for (int y = t; y < kMaxSide; y += kThreads) cur[y] = cnt[y];
  __syncthreads();
  scan_1024(cur, warp_sums);                 // cur[y]: the first row of column y
  for (int q = t; q < n; q += kThreads) {
    const uint2 r = rec[base + q];
    tmp[base + atomicAdd(&cur[(r.x >> bits) & mask], 1u)] = r;
  }
  __syncthreads();                           // cur[y]: one past column y's last row
  // the dedup: a row is kept when no row of its column has its z and a
  // lower point index
  for (int q = t; q < n; q += kThreads) {
    const uint2 r = tmp[base + q];
    const uint32_t y = (r.x >> bits) & mask, z = r.x & mask;
    const unsigned int c1 = cur[y], c0 = c1 - cnt[y];
    bool keep = true;
    for (unsigned int u = c0; u < c1 && keep; ++u) {
      const uint2 o = tmp[base + u];
      keep = !((o.x & mask) == z && o.y < r.y);
    }
    if (keep) {
      tmp[base + q].x = r.x | kLeader;
      atomicAdd(&ucnt[y], 1u);
    }
  }
  __syncthreads();
  unsigned int interior = 0;
  for (int q = t; q < n; q += kThreads) {
    const uint2 r = tmp[base + q];
    int rk = -1;
    if (r.x & kLeader) {
      const uint32_t y = (r.x >> bits) & mask, z = r.x & mask;
      const unsigned int c1 = cur[y], c0 = c1 - cnt[y];
      rk = 0;
      for (unsigned int u = c0; u < c1; ++u) {
        const uint32_t o = tmp[base + u].x;
        rk += (o & kLeader) && (o & mask) < z;
      }
      interior += (r.x & kInterior) != 0u;
    }
    rank[base + q] = rk;
  }
  atomicAdd(&interior_total, interior);
  const unsigned int total = scan_1024(ucnt, warp_sums);   // ucnt[y]: column y's first rank
  for (int q = t; q < n; q += kThreads) {
    const int rk = rank[base + q];
    if (rk >= 0) rank[base + q] = rk + static_cast<int>(ucnt[(tmp[base + q].x >> bits) & mask]);
  }
  if (t == 0) {
    ucount[s] = total;
    if (interior_total) atomicAdd(&hdr[kCounts + nb + s / side], interior_total);
  }
}

// One CTA a slab: each kept row written at vstart[s] + its rank. The first
// slab of each block writes the block's voxel count to the header.
__global__ void __launch_bounds__(kThreads)
tiler_slab_emit(const unsigned int* __restrict__ start, const uint2* __restrict__ tmp,
                 const int* __restrict__ rank, const unsigned int* __restrict__ vstart, int side,
                 int bits, int* __restrict__ key, int* __restrict__ first,
                 unsigned char* __restrict__ interior, unsigned long long* __restrict__ hdr) {
  const long long s = blockIdx.x;
  const int x = static_cast<int>(s % side);
  if (x == 0 && threadIdx.x == 0)
    hdr[kCounts + s / side] = vstart[s + side] - vstart[s];
  const unsigned int base = start[s];
  const int n = static_cast<int>(start[s + 1] - base);
  const unsigned int v0 = vstart[s];
  const uint32_t yz_mask = (1u << (2 * bits)) - 1u;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int rk = rank[base + q];
    if (rk < 0) continue;
    const uint2 r = tmp[base + q];
    const unsigned int at = v0 + static_cast<unsigned int>(rk);
    key[at] = static_cast<int>((static_cast<uint32_t>(x) << (2 * bits)) | (r.x & yz_mask));
    first[at] = static_cast<int>(r.y);
    interior[at] = (r.x & kInterior) ? 1 : 0;
  }
}

// One thread a row of the batch: the row's slot by a binary search of the
// slot offsets, its block's voxel, the int64 key with the slot on top, the
// residual from the voxel centre in float64, the interior flag and the point
// index. Threads below batch_size also write the batch's origins (zeros for
// the empty slots).
__global__ void __launch_bounds__(kThreads)
tiler_gather(const long long* __restrict__ table, int slots, int batch_size, long long rows,
              const int* __restrict__ key, const int* __restrict__ first,
              const unsigned char* __restrict__ interior_in, const unsigned int* __restrict__ vstart,
              int side, const float* __restrict__ origin, const float* __restrict__ xyz,
              double voxel, double step, int bits, int int8_res, long long* __restrict__ out_key,
              void* __restrict__ out_res, unsigned char* __restrict__ out_interior,
              int* __restrict__ out_index, float* __restrict__ out_origin) {
  const long long r = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long* blocks = table;
  const long long* offsets = table + slots;
  if (r < batch_size) {
    for (int a = 0; a < 3; ++a)
      out_origin[3 * r + a] = r < slots ? origin[3 * blocks[r] + a] : 0.f;
  }
  if (r >= rows) return;
  int lo = 0, hi = slots - 1;            // the last slot whose offset is <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= r) lo = mid; else hi = mid - 1;
  }
  const long long j = blocks[lo];
  const long long v = vstart[j * side] + (r - offsets[lo]);
  const uint32_t k = static_cast<uint32_t>(key[v]);
  out_key[r] = (static_cast<long long>(lo) << (3 * bits)) | static_cast<long long>(k);
  const int i = first[v];
  out_index[r] = i;
  out_interior[r] = interior_in[v];
  const uint32_t mask = (1u << bits) - 1u;
  const uint32_t g[3] = {k >> (2 * bits), (k >> bits) & mask, k & mask};
  for (int a = 0; a < 3; ++a) {
    // numpy's origins[b] + (coords + 0.5) * voxel_size, then feats - centre
    const double centre = __dadd_rn(static_cast<double>(origin[3 * j + a]),
                                    __dmul_rn(__dadd_rn(static_cast<double>(g[a]), 0.5), voxel));
    const double res = __dsub_rn(static_cast<double>(xyz[3 * i + a]), centre);
    if (int8_res) {
      const double q = fmin(fmax(rint(__ddiv_rn(res, step)), -127.0), 127.0);
      static_cast<signed char*>(out_res)[3 * r + a] = static_cast<signed char>(q);
    } else {
      static_cast<__half*>(out_res)[3 * r + a] = __double2half(res);
    }
  }
}

inline int grid_of(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Step 1 of the tiling: xyz [n, 3] fp32, ids [nb, 3] int64 sorted, origin
// [nb, 3] fp32 set to +inf, hdr (zeroed) int64 [3 + 2 nb]. Adds the
// point-box tests and halo rows to hdr[0], hdr[1]. Returns the cudaError_t
// of the launch, or an invalid-value error on bad sizes.
int st_tile_bin(const void* xyz, long long n, const void* ids, int nb, double block,
                double half_block, double half_halo, double half_in, int reach, void* origin,
                void* hdr, void* stream) {
  if (n < 0 || n >= (1LL << 31) || nb <= 0 || reach < 1 || 2 * reach + 1 > kMaxWindow ||
      !(block > 0.0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Faces f{block, half_block, half_halo, half_in, reach};
  tiler_bin<<<grid_of(n), kThreads, 0, s>>>(
      static_cast<const float*>(xyz), n, static_cast<const long long*>(ids), nb, f,
      static_cast<float*>(origin), static_cast<unsigned long long*>(hdr));
  return (int)cudaGetLastError();
}

// Steps 2 to 4, given the halo rows counted by st_tile_bin: slab counts
// `count` and `ucount` [nb * side] uint32 zeroed, `start` and `vstart` [nb *
// side + 1] uint32, rec and tmp [rows] uint2 (8 B), rank [rows] int32; out:
// key and first [rows] int32 and interior [rows] uint8, each block's voxels
// from vstart[b * side] on; hdr[2] the rows outside the grid, hdr[3 ..] the
// voxel and interior counts. Six launches; returns the first failed
// launch's cudaError_t, or 0.
int st_tile_sort(const void* xyz, long long n, const void* ids, int nb, double block,
                 double half_block, double half_halo, double half_in, int reach,
                 const void* origin, float voxel, int side, int bits, long long rows,
                 void* count, void* start, void* rec, void* tmp, void* rank, void* ucount,
                 void* vstart, void* key, void* first, void* interior, void* hdr, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || nb <= 0 || reach < 1 || 2 * reach + 1 > kMaxWindow ||
      side <= 0 || side > kMaxSide || bits < 1 || bits > 10 || (1 << bits) < side ||
      rows < 0 || rows >= (1LL << 31) || !(block > 0.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Faces f{block, half_block, half_halo, half_in, reach};
  const long long slabs = static_cast<long long>(nb) * side;
  if (slabs >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(xyz);
  const long long* id = static_cast<const long long*>(ids);
  const float* o = static_cast<const float*>(origin);
  unsigned int* cnt = static_cast<unsigned int*>(count);
  unsigned int* beg = static_cast<unsigned int*>(start);
  unsigned long long* h = static_cast<unsigned long long*>(hdr);
  tiler_slab_count<<<grid_of(n), kThreads, 0, st>>>(p, n, id, nb, f, o, voxel, side, cnt, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tiler_scan<<<1, kScanThreads, 0, st>>>(cnt, slabs, beg);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tiler_slab_fill<<<grid_of(n), kThreads, 0, st>>>(p, n, id, nb, f, o, voxel, side, bits, beg,
                                                     cnt, static_cast<uint2*>(rec));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tiler_slab_sort<<<static_cast<unsigned int>(slabs), kThreads, 0, st>>>(
      beg, static_cast<const uint2*>(rec), static_cast<uint2*>(tmp), static_cast<int*>(rank),
      static_cast<unsigned int*>(ucount), side, bits, nb, h);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tiler_scan<<<1, kScanThreads, 0, st>>>(static_cast<const unsigned int*>(ucount), slabs,
                                          static_cast<unsigned int*>(vstart));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tiler_slab_emit<<<static_cast<unsigned int>(slabs), kThreads, 0, st>>>(
      beg, static_cast<const uint2*>(tmp), static_cast<const int*>(rank),
      static_cast<const unsigned int*>(vstart), side, bits, static_cast<int*>(key),
      static_cast<int*>(first), static_cast<unsigned char*>(interior), h);
  return (int)cudaGetLastError();
}

// One batch: table int64 [2 slots + 1] (each slot's block, then the slots'
// row offsets, the last the batch's rows), the tiling's key / first /
// interior / vstart / origin, xyz; out: key int64 [rows], res [rows, 3] int8
// (int8_res) or fp16, interior uint8 [rows], index int32 [rows], origin fp32
// [batch_size, 3]. Returns the launch's cudaError_t.
int st_tile_gather(const void* table, int slots, int batch_size, long long rows, const void* key,
                   const void* first, const void* interior, const void* vstart, int side,
                   const void* origin, const void* xyz, double voxel, double step, int bits,
                   int int8_res, void* out_key, void* out_res, void* out_interior,
                   void* out_index, void* out_origin, void* stream) {
  if (slots <= 0 || batch_size < slots || rows < 0 || rows >= (1LL << 31) || side <= 0 ||
      bits < 1 || bits > 10)
    return (int)cudaErrorInvalidValue;
  const long long threads = rows > batch_size ? rows : batch_size;
  tiler_gather<<<grid_of(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), slots, batch_size, rows,
      static_cast<const int*>(key), static_cast<const int*>(first),
      static_cast<const unsigned char*>(interior), static_cast<const unsigned int*>(vstart),
      side, static_cast<const float*>(origin), static_cast<const float*>(xyz), voxel, step, bits,
      int8_res, static_cast<long long*>(out_key), out_res,
      static_cast<unsigned char*>(out_interior), static_cast<int*>(out_index),
      static_cast<float*>(out_origin));
  return (int)cudaGetLastError();
}

}  // extern "C"
