// Slab gather-conv for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smart_tree_tpu/core/pallas_slab.py::
// slab_gather_conv (pl.pallas_call at pallas_slab.py:269):
//
//   out[M, Cout] = sum_k bf16(feats[rb[i, k]]) . bf16(W[k]),  fp32 accumulation,
//
// with rb[i, k] = -1 reading zero. Every rulebook column is monotone over
// the sorted keys, so a tile of consecutive output rows reads, for each of
// the 9 (dx, dy) groups (three dz columns each), one contiguous "slab" of
// the feature table. The caller (core/slab_conv.py::_precompute) gives per
// tile and group the slab start, the number of slab-sized chunks, and the
// rulebook rebased to slab-relative rows.
//
// Design. One CTA per tile of TILE output rows, 256 threads, each thread
// owning 8 output columns of one row (TILE = 256 * 8 / COUT). For each group
// and chunk the CTA stages the slab's rows, rounded to bf16, in shared memory
// (row pitch padded by 8 elements so neighbouring rows start on different
// banks), plus the group's three weight slices, rounded to bf16 and kept as
// fp32. Each output row then reads its three rows straight from shared memory
// by relative index -- the TPU version needed one-hot matmuls only because
// Mosaic has no dynamic VMEM indexing -- and accumulates bf16 x bf16 products
// (exact in fp32) in fp32 registers. Slab loads stop at the group's last
// referenced row and at N; a group with no valid entry in the tile is skipped.
//
// What bounds it: at the shapes the UNet gives it (Cin 8..64, Cout 8..32)
// the work is 2 * 27 * Cin * Cout FLOPs per output row against ~27 * 4 bytes
// of rulebook and Cin * 4 bytes of table per row, so the ideal kernel is bound
// by device-memory bytes, not operations. This first version uses plain loads
// and scalar FMAs; cp.async/TMA staging and mma/wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;     // output columns per thread
constexpr int kPad = 8;      // bf16 elements of padding per staged slab row

template <int COUT>
__global__ void __launch_bounds__(kThreads)
slab_conv_kernel(const float* __restrict__ feats, int n, int cin,
                 const int* __restrict__ rel, const int* __restrict__ starts,
                 const int* __restrict__ nchunks,
                 const float* __restrict__ weights,
                 float* __restrict__ out, int m, int slab) {
  constexpr int TPR = COUT / kCols;   // threads per output row
  constexpr int TILE = kThreads / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int span_s;
  const int pitch = cin + kPad;
  __nv_bfloat16* slab_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + (size_t)slab * pitch * sizeof(__nv_bfloat16));

  const int tile = blockIdx.x;
  const int r = threadIdx.x / TPR;
  const int cg = threadIdx.x % TPR;
  const int row = tile * TILE + r;   // rel is padded to whole tiles
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int g = 0; g < 9; ++g) {
    const int nch = nchunks[tile * 9 + g];
    if (nch == 0) continue;           // uniform over the CTA
    const int start = starts[tile * 9 + g];
    int relk[3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) relk[dz] = rel[(size_t)row * 27 + 3 * g + dz];

    __syncthreads();                  // previous group is done with smem
    if (threadIdx.x == 0) span_s = -1;
    const float* wg = weights + (size_t)(3 * g) * cin * COUT;
    for (int i = threadIdx.x; i < 3 * cin * COUT; i += kThreads)
      w_s[i] = __bfloat162float(__float2bfloat16_rn(wg[i]));
    __syncthreads();
    if (cg == 0) {
      const int mx = max(relk[0], max(relk[1], relk[2]));
      if (mx >= 0) atomicMax(&span_s, mx);
    }
    __syncthreads();
    const int span = span_s + 1;      // rows [start, start + span) are read

    for (int c = 0; c < nch; ++c) {
      const int base = start + c * slab;
      const int rows = min(min(slab, span - c * slab), n - base);
      if (c > 0) __syncthreads();     // previous chunk is done with the slab
      const int q = cin / 4;          // float4 per table row
      for (int i = threadIdx.x; i < rows * q; i += kThreads) {
        const int rr = i / q, cc = (i - rr * q) * 4;
        const float4 v = *reinterpret_cast<const float4*>(feats + (size_t)(base + rr) * cin + cc);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(slab_s + rr * pitch + cc);
        dst[0] = __floats2bfloat162_rn(v.x, v.y);
        dst[1] = __floats2bfloat162_rn(v.z, v.w);
      }
      __syncthreads();
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int rl = relk[dz] - c * slab;
        if (relk[dz] < 0 || rl < 0 || rl >= rows) continue;
        const __nv_bfloat16* xr = slab_s + rl * pitch;
        const float* wk = w_s + dz * cin * COUT + cg * kCols;
        for (int ci = 0; ci < cin; ci += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + ci);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float x[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            x[2 * j] = f.x;
            x[2 * j + 1] = f.y;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float* wr = wk + (ci + j) * COUT;
            const float4 w0 = *reinterpret_cast<const float4*>(wr);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
            acc[0] = fmaf(x[j], w0.x, acc[0]);
            acc[1] = fmaf(x[j], w0.y, acc[1]);
            acc[2] = fmaf(x[j], w0.z, acc[2]);
            acc[3] = fmaf(x[j], w0.w, acc[3]);
            acc[4] = fmaf(x[j], w1.x, acc[4]);
            acc[5] = fmaf(x[j], w1.y, acc[5]);
            acc[6] = fmaf(x[j], w1.z, acc[6]);
            acc[7] = fmaf(x[j], w1.w, acc[7]);
          }
        }
      }
    }
  }
  if (row < m) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)row * COUT + cg * kCols);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

template <int COUT>
cudaError_t launch(const float* feats, int n, int cin, const int* rel,
                   const int* starts, const int* nchunks, int tiles,
                   const float* weights, float* out, int m, int slab,
                   cudaStream_t stream) {
  const size_t smem = (size_t)slab * (cin + kPad) * sizeof(__nv_bfloat16) +
                      (size_t)3 * cin * COUT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slab_conv_kernel<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  slab_conv_kernel<COUT><<<tiles, kThreads, smem, stream>>>(
      feats, n, cin, rel, starts, nchunks, weights, out, m, slab);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output rows per CTA for a given Cout: the tile the caller's _precompute
// must use.
int st_slab_conv_tile(int cout) { return kThreads * kCols / cout; }

// feats [n, cin] fp32, rel [tiles * tile, 27] int32 (slab-relative, -1 = none),
// starts / nchunks [tiles, 9] int32 (starts in table rows), weights
// [27, cin, cout] fp32, out [m, cout] fp32. cin % 8 == 0, cin <= 64,
// cout in {8, 16, 32, 64}. Returns the cudaError_t of the launch.
int st_slab_conv(const void* feats, int n, int cin, const void* rel,
                 const void* starts, const void* nchunks, int tiles,
                 const void* weights, int cout, void* out, int m, int slab,
                 void* stream) {
  if (cin % 8 != 0 || cin > 64 || slab <= 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const int* rl = static_cast<const int*>(rel);
  const int* st = static_cast<const int*>(starts);
  const int* nc = static_cast<const int*>(nchunks);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: return (int)launch<8>(f, n, cin, rl, st, nc, tiles, w, o, m, slab, s);
    case 16: return (int)launch<16>(f, n, cin, rl, st, nc, tiles, w, o, m, slab, s);
    case 32: return (int)launch<32>(f, n, cin, rl, st, nc, tiles, w, o, m, slab, s);
    case 64: return (int)launch<64>(f, n, cin, rl, st, nc, tiles, w, o, m, slab, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
