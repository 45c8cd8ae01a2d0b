// Greedy branch tracer steps for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the tracer as an XLA loop,
// smart_tree_tpu/skeleton/path.py:224 `_sample_chunk`, up to 256 greedy
// iterations in one device program with one scalar fetch a dispatch. The
// port's eager form queued about 250 torch calls and fetched a scalar every
// iteration. Here one iteration is three launches that read everything they
// need (the lengths, the branch count, whether there is work at all) from
// a header in device memory, so the host queues a round of iterations
// (skeleton/path.py ROUND) and fetches the header once a round.
//
// One iteration, as skeleton/path.py::greedy_step_plain computes it:
//
//   1. seed_trace (one block): the farthest vertex (the first index among
//      equal maxima of dist, as torch.argmax), no work when it is not > 0,
//      the branch cap when count >= max_branches; then its chain of
//      predecessors up to the first allocated vertex, the root sentinel or
//      hop_cap (pred^j(start) from the pointer-doubling tables, 1024 hops a
//      chunk), the path root side first, and for each window of kWin path
//      vertices the centre of its bounding box and its largest radius
//      squared, with the vertices centred on it.
//   2. select (a grid over the N vertices): a still valid vertex (dist >= 0)
//      finds its nearest path vertex window by window, in the exact centred
//      form ((p - c) - (v - c)), squared and summed x, y, z in order, each
//      operation rounded on its own (no FMA contraction); ties go to the
//      lowest window position; a window's nearest counts when its d2 is
//      within the window's largest radius squared; across windows the square
//      of the rounded root carries, strict <, with that vertex's radius; the
//      vertex is taken when sqrt(best d2) < that radius. A taken vertex
//      writes only its own entries.
//   3. write_path (one block): the path's vertices allocated, their dist -1,
//      and for a path of two or more vertices the branch ids, positions and
//      parent, and the count.
//
// What bounds it. Latency, not bytes: a one-block max over N floats (N is
// about 1e5 in a tree cloud, read from L2), 10 to 14 dependent gathers of
// the jump tables, and one pass of the valid vertices against the path,
// where the path lengths of a cloud sum to at most N. Each kernel is a few
// microseconds; the design's point is that no value goes to the host
// between iterations, so the host queues ahead of the device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// header slots (int64), in skeleton/path.py's order
constexpr int kNoWork = 0;   // an iteration found no vertex with dist > 0
constexpr int kCapHit = 1;   // an iteration found work at max_branches
constexpr int kCount = 2;    // branches emitted
constexpr int kHops = 3;     // traces truncated at hop_cap
constexpr int kIters = 4;    // real iterations
constexpr int kLive = 5;     // this iteration traced a path
constexpr int kLen = 6;      // its length
constexpr int kTerm = 7;     // its termination vertex, or -1
constexpr int kHopHit = 8;   // it stopped at hop_cap with the tree going on
constexpr int kParent = 9;   // branch owning the termination vertex, or -1

constexpr int kWin = 128;          // path vertices a window (path.py SEL_CHUNK)
constexpr int kTraceThreads = 1024;
constexpr int kTraceShift = 10;    // log2(kTraceThreads): the level of one chunk's jump
constexpr int kSelThreads = 256;
constexpr int kStage = 8;          // windows staged in shared memory at once
constexpr int kWriteThreads = 256;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kTraceThreads)
seed_trace_kernel(const float* __restrict__ dist, int n, const long long* __restrict__ jumps,
                  int levels, const unsigned char* __restrict__ allocated,
                  const long long* __restrict__ branch_ids, const float* __restrict__ pts,
                  const float* __restrict__ radii, int hop_cap, int max_branches,
                  int* __restrict__ chain, int* __restrict__ path, float4* __restrict__ pathv,
                  float4* __restrict__ win, long long* __restrict__ hdr) {
  __shared__ float s_val[kTraceThreads / 32];
  __shared__ int s_idx[kTraceThreads / 32];
  __shared__ int s_start, s_first;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (hdr[kNoWork] | hdr[kCapHit]) {  // an earlier iteration ended the trace
    if (t == 0) hdr[kLive] = 0;
    return;
  }

  // the farthest vertex: (value, index) maximal, the lowest index of a tie
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  const int n4 = n >> 2;
  const float4* d4 = reinterpret_cast<const float4*>(dist);
#pragma unroll 4
  for (int i = t; i < n4; i += kTraceThreads) {
    const float4 x = d4[i];
    if (better(x.x, 4 * i, bv, bi)) { bv = x.x; bi = 4 * i; }
    if (better(x.y, 4 * i + 1, bv, bi)) { bv = x.y; bi = 4 * i + 1; }
    if (better(x.z, 4 * i + 2, bv, bi)) { bv = x.z; bi = 4 * i + 2; }
    if (better(x.w, 4 * i + 3, bv, bi)) { bv = x.w; bi = 4 * i + 3; }
  }
  if (4 * n4 + t < n && better(dist[4 * n4 + t], 4 * n4 + t, bv, bi)) {
    bv = dist[4 * n4 + t];
    bi = 4 * n4 + t;
  }
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    bv = s_val[lane];
    bi = s_idx[lane];
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) {
      s_start = -1;
      if (!(bv > 0.f)) {
        hdr[kNoWork] = 1;
        hdr[kLive] = 0;
      } else if (hdr[kCount] >= max_branches) {
        hdr[kCapHit] = 1;
        hdr[kLive] = 0;
      } else {
        s_start = bi;
      }
      s_first = hop_cap;
    }
  }
  __syncthreads();
  const int start = s_start;
  if (start < 0) return;

  // chain[j] = pred^j(start), 1024 hops a chunk, to the first stop
  const long long stride = static_cast<long long>(n) + 1;
  int v = start;
  if (t < hop_cap)
    for (int k = 0; k < kTraceShift && k < levels; ++k)
      if ((t >> k) & 1) v = static_cast<int>(jumps[k * stride + v]);
  for (int base = 0; base < hop_cap; base += kTraceThreads) {
    const int j = base + t;
    bool stop = false;
    if (j < hop_cap) {
      chain[j] = v;
      stop = v >= n || allocated[v];
      if (stop) atomicMin(&s_first, j);
    }
    if (__syncthreads_or(stop)) break;
    if (base + kTraceThreads < hop_cap) v = static_cast<int>(jumps[kTraceShift * stride + v]);
  }
  const int length = s_first;

  if (t == 0) {
    long long term;
    if (length < hop_cap) {
      term = chain[length];
    } else {  // pred^hop_cap(start): the sequential trace's stop when hop-capped
      long long vh = start;
      for (int k = 0; k < levels; ++k)
        if ((hop_cap >> k) & 1) vh = jumps[k * stride + vh];
      term = vh;
    }
    if (term >= n) term = -1;
    hdr[kLive] = 1;
    hdr[kLen] = length;
    hdr[kTerm] = term;
    hdr[kHopHit] = length >= hop_cap && term >= 0 && !allocated[term];
    hdr[kParent] = term >= 0 ? branch_ids[term] : -1;
  }

  // the path root side first, and its windows: a warp a window
  const int nwin = (length + kWin - 1) / kWin;
  for (int w = warp; w < nwin; w += kTraceThreads / 32) {
    float x[kWin / 32], y[kWin / 32], z[kWin / 32], r[kWin / 32];
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY, rmax = -INFINITY;
#pragma unroll
    for (int m = 0; m < kWin / 32; ++m) {
      const int i = w * kWin + m * 32 + lane;
      if (i < length) {
        const int pv = chain[length - 1 - i];
        path[i] = pv;
        x[m] = pts[3 * static_cast<size_t>(pv)];
        y[m] = pts[3 * static_cast<size_t>(pv) + 1];
        z[m] = pts[3 * static_cast<size_t>(pv) + 2];
        r[m] = radii[pv];
        lx = fminf(lx, x[m]); hx = fmaxf(hx, x[m]);
        ly = fminf(ly, y[m]); hy = fmaxf(hy, y[m]);
        lz = fminf(lz, z[m]); hz = fmaxf(hz, z[m]);
        rmax = fmaxf(rmax, r[m]);
      }
    }
    for (int o = 16; o; o >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
      ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
      lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
      hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, o));
      hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, o));
      hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, o));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    }
    const float cx = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    const float cy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    const float cz = __fmul_rn(__fadd_rn(lz, hz), 0.5f);
#pragma unroll
    for (int m = 0; m < kWin / 32; ++m) {
      const int i = w * kWin + m * 32 + lane;
      if (i < length)
        pathv[i] = make_float4(__fsub_rn(x[m], cx), __fsub_rn(y[m], cy), __fsub_rn(z[m], cz),
                               r[m]);
    }
    if (lane == 0) win[w] = make_float4(cx, cy, cz, __fmul_rn(rmax, rmax));
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ pts, int n, const float4* __restrict__ pathv,
              const float4* __restrict__ win, float* __restrict__ dist,
              unsigned char* __restrict__ allocated, long long* __restrict__ branch_ids,
              const long long* __restrict__ hdr) {
  __shared__ float4 sv[kStage * kWin];
  __shared__ float4 sw[kStage];
  if (!hdr[kLive]) return;
  const int length = static_cast<int>(hdr[kLen]);
  const int p = blockIdx.x * kSelThreads + threadIdx.x;
  const bool valid = p < n && dist[p] >= 0.f;
  if (!__syncthreads_or(valid)) return;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = pts[3 * static_cast<size_t>(p)];
    py = pts[3 * static_cast<size_t>(p) + 1];
    pz = pts[3 * static_cast<size_t>(p) + 2];
  }
  float best_d2 = INFINITY, best_r = 0.f;
  const int nwin = (length + kWin - 1) / kWin;
  for (int w0 = 0; w0 < nwin; w0 += kStage) {
    const int nw = min(kStage, nwin - w0);
    const int lo = w0 * kWin, cnt = min(length - lo, nw * kWin);
    for (int i = threadIdx.x; i < cnt; i += kSelThreads) sv[i] = pathv[lo + i];
    if (threadIdx.x < nw) sw[threadIdx.x] = win[w0 + threadIdx.x];
    __syncthreads();
    if (valid) {
      for (int w = 0; w < nw; ++w) {
        const float4 c = sw[w];
        const float qx = __fsub_rn(px, c.x), qy = __fsub_rn(py, c.y), qz = __fsub_rn(pz, c.z);
        const int e = min((w + 1) * kWin, cnt);
        float dmin = INFINITY;
        int imin = -1;
        for (int i = w * kWin; i < e; ++i) {
          const float4 q = sv[i];
          const float dx = __fsub_rn(qx, q.x), dy = __fsub_rn(qy, q.y), dz = __fsub_rn(qz, q.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          if (d2 < dmin) { dmin = d2; imin = i; }
        }
        if (imin >= 0 && dmin <= c.w) {
          const float d = __fsqrt_rn(dmin);
          const float dd = __fmul_rn(d, d);
          if (dd < best_d2) { best_d2 = dd; best_r = sv[imin].w; }
        }
      }
    }
    __syncthreads();
  }
  if (valid && best_d2 < INFINITY && __fsqrt_rn(best_d2) < best_r) {
    allocated[p] = 1;
    dist[p] = -1.f;
    if (length >= 2) branch_ids[p] = hdr[kCount];
  }
}

__global__ void __launch_bounds__(kWriteThreads)
write_path_kernel(const int* __restrict__ path, float* __restrict__ dist,
                  unsigned char* __restrict__ allocated, long long* __restrict__ branch_ids,
                  long long* __restrict__ path_branch, long long* __restrict__ path_pos,
                  long long* __restrict__ parents, long long* __restrict__ hdr) {
  if (!hdr[kLive]) return;
  const int length = static_cast<int>(hdr[kLen]);
  const long long bid = hdr[kCount];
  const bool branch = length >= 2;
  for (int i = threadIdx.x; i < length; i += kWriteThreads) {
    const int v = path[i];
    allocated[v] = 1;
    dist[v] = -1.f;
    if (branch) {
      branch_ids[v] = bid;
      path_branch[v] = bid;
      path_pos[v] = i;
    }
  }
  __syncthreads();  // every thread has read the header before it changes
  if (threadIdx.x == 0) {
    if (branch) {
      parents[bid] = hdr[kParent];
      hdr[kCount] = bid + 1;
    }
    hdr[kHops] += hdr[kHopHit];
    hdr[kIters] += 1;
  }
}

}  // namespace

extern "C" {

// Queues `steps` greedy iterations on `stream`; each one after the trace
// ended (no work, or the branch cap) does nothing. pts [n, 3] fp32, radii
// [n] fp32, jumps [levels, n + 1] int64 (path.py::build_jump_tables), dist
// [n] fp32 (16-byte aligned), allocated [n + 1] uint8 (row n set), branch_ids
// / path_branch / path_pos [n] int64, parents [max_branches] int64; scratch
// chain and path [hop_cap] int32, pathv [hop_cap] float4, win
// [ceil(hop_cap / 128)] float4; hdr [10] int64. Returns the cudaError_t of
// the first launch that failed, or 0.
int st_tracer_steps(const void* pts, const void* radii, const void* jumps, int levels, int n,
                    void* dist, void* allocated, void* branch_ids, void* path_branch,
                    void* path_pos, void* parents, int max_branches, int hop_cap, void* chain,
                    void* path, void* pathv, void* win, void* hdr, int steps, void* stream) {
  if (n <= 0 || n == 0x7fffffff || hop_cap <= 0 || levels < 1 || max_branches < 0 ||
      steps < 0 || (1LL << levels) <= hop_cap ||
      (hop_cap > kTraceThreads && levels <= kTraceShift) ||
      (reinterpret_cast<uintptr_t>(dist) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sel_blocks = (n + kSelThreads - 1) / kSelThreads;
  for (int i = 0; i < steps; ++i) {
    seed_trace_kernel<<<1, kTraceThreads, 0, s>>>(
        static_cast<const float*>(dist), n, static_cast<const long long*>(jumps), levels,
        static_cast<const unsigned char*>(allocated), static_cast<const long long*>(branch_ids),
        static_cast<const float*>(pts), static_cast<const float*>(radii), hop_cap,
        max_branches, static_cast<int*>(chain), static_cast<int*>(path),
        static_cast<float4*>(pathv), static_cast<float4*>(win), static_cast<long long*>(hdr));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    select_kernel<<<sel_blocks, kSelThreads, 0, s>>>(
        static_cast<const float*>(pts), n, static_cast<const float4*>(pathv),
        static_cast<const float4*>(win), static_cast<float*>(dist),
        static_cast<unsigned char*>(allocated), static_cast<long long*>(branch_ids),
        static_cast<const long long*>(hdr));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    write_path_kernel<<<1, kWriteThreads, 0, s>>>(
        static_cast<const int*>(path), static_cast<float*>(dist),
        static_cast<unsigned char*>(allocated), static_cast<long long*>(branch_ids),
        static_cast<long long*>(path_branch), static_cast<long long*>(path_pos),
        static_cast<long long*>(parents), static_cast<long long*>(hdr));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
