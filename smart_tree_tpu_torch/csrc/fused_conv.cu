// Fused gather-GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel smart_tree_tpu/core/pallas_ops.py::
// fused_gather_gemm (pl.pallas_call at pallas_ops.py:86):
//
//   out[M, Cout] = gather(feats U zero row, rb)[M, K3 * Cin] @ W[K3 * Cin, Cout]
//
// for any K3, in fp32 with fp32 accumulation; rb[i, k] = -1 reads the zero
// row. No monotonicity is assumed, so it serves any rulebook.
//
// Design. The TPU kernel kept the whole table (<= 8 MiB) resident in VMEM;
// an H100 block has 227 KB of shared memory, so here the table stays in
// device memory and the 50 MB L2 serves the repeated reads. One CTA per tile
// of TILE output rows, 256 threads, each owning 8 output columns of one row
// (TILE = 256 * 8 / COUT). The CTA stages its [TILE, K3] rulebook rows in
// shared memory once, then for each kernel offset k gathers the TILE table
// rows it names into shared memory (float4 loads, rows padded by 4 floats to
// spread banks) together with W[k], and accumulates in fp32 registers.
//
// What bounds it: 2 * K3 * Cin * Cout FLOPs per output row against
// K3 * 4 bytes of rulebook plus the gathered rows, which L2 mostly serves;
// the ideal kernel is bound by device-memory bytes at these channel widths.
// This first version uses plain loads and scalar FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;    // output columns per thread
constexpr int kPad = 4;     // floats of padding per staged row

template <int COUT>
__global__ void __launch_bounds__(kThreads)
fused_conv_kernel(const float* __restrict__ feats, int n, int cin,
                  const int* __restrict__ rb, int m, int k3,
                  const float* __restrict__ weights, float* __restrict__ out) {
  constexpr int TPR = COUT / kCols;
  constexpr int TILE = kThreads / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = cin + kPad;
  float* g_s = reinterpret_cast<float*>(smem);                  // [TILE, pitch]
  float* w_s = g_s + (size_t)TILE * pitch;                      // [cin, COUT]
  int* rb_s = reinterpret_cast<int*>(w_s + (size_t)cin * COUT); // [TILE, k3]

  const int tile0 = blockIdx.x * TILE;
  const int r = threadIdx.x / TPR;
  const int cg = threadIdx.x % TPR;
  const int row = tile0 + r;

  for (int i = threadIdx.x; i < TILE * k3; i += kThreads) {
    const int rr = i / k3;
    rb_s[i] = (tile0 + rr < m) ? rb[(size_t)tile0 * k3 + i] : -1;
  }
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  const int q = cin / 4;
  for (int k = 0; k < k3; ++k) {
    __syncthreads();   // rulebook staged / previous offset done with smem
    for (int i = threadIdx.x; i < TILE * q; i += kThreads) {
      const int rr = i / q, cc = (i - rr * q) * 4;
      const int src = rb_s[rr * k3 + k];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0 && src < n)
        v = *reinterpret_cast<const float4*>(feats + (size_t)src * cin + cc);
      *reinterpret_cast<float4*>(g_s + rr * pitch + cc) = v;
    }
    const float* wk = weights + (size_t)k * cin * COUT;
    for (int i = threadIdx.x; i < cin * COUT; i += kThreads) w_s[i] = wk[i];
    __syncthreads();
    if (rb_s[r * k3 + k] < 0) continue;   // zero row contributes nothing
    const float* xr = g_s + r * pitch;
    const float* wc = w_s + cg * kCols;
    for (int ci = 0; ci < cin; ci += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + ci);
      const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* wr = wc + (ci + j) * COUT;
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
  if (row < m) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)row * COUT + cg * kCols);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

template <int COUT>
cudaError_t launch(const float* feats, int n, int cin, const int* rb, int m,
                   int k3, const float* weights, float* out, cudaStream_t stream) {
  constexpr int TILE = kThreads / (COUT / kCols);
  const size_t smem = (size_t)TILE * (cin + kPad) * sizeof(float) +
                      (size_t)cin * COUT * sizeof(float) +
                      (size_t)TILE * k3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (m + TILE - 1) / TILE;
  fused_conv_kernel<COUT><<<tiles, kThreads, smem, stream>>>(
      feats, n, cin, rb, m, k3, weights, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats [n, cin] fp32, rulebook [m, k3] int32 (-1 = zero row), weights
// [k3, cin, cout] fp32, out [m, cout] fp32. cin % 4 == 0, cin <= 128,
// cout in {8, 16, 32, 64}. Returns the cudaError_t of the launch.
int st_fused_conv(const void* feats, int n, int cin, const void* rulebook,
                  int m, int k3, const void* weights, int cout, void* out,
                  void* stream) {
  if (cin % 4 != 0 || cin > 128 || k3 <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const int* rb = static_cast<const int*>(rulebook);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: return (int)launch<8>(f, n, cin, rb, m, k3, w, o, s);
    case 16: return (int)launch<16>(f, n, cin, rb, m, k3, w, o, s);
    case 32: return (int)launch<32>(f, n, cin, rb, m, k3, w, o, s);
    case 64: return (int)launch<64>(f, n, cin, rb, m, k3, w, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
