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
// What bounds it. The contract is a full fp32 product, so the tensor cores
// (TF32, bf16) are out and the work runs on fp32 FMAs: 2 * Cin * Cout
// operations per valid rulebook entry at 67 TFLOP/s, against K3 * 4 bytes of
// rulebook per row, the table and the output. From Cin * Cout of about
// 16 * 16 up the FMAs bound it; below that the bytes do. The UNet's
// rulebooks are sparse (4 to 44 % of the entries are valid, half of the
// padded rows have none), so the work that counts is the valid entries'.
// The table stays in device memory, whatever its size, and the 50 MB L2
// serves the repeated reads; the TPU kernel's VMEM-resident table (and its
// 8 MiB gate) has no counterpart in 227 KB of shared memory.
//
// Design. One CTA computes a tile of kTile = 128 output rows and all of Cout,
// whatever Cout is.
//   * Compaction. The tile's [128, K3] rulebook rows are staged once; per
//     kernel offset k a warp ballots the rows that have a neighbour there
//     into a list. Only those rows are gathered and multiplied: an offset
//     with no row in the tile costs nothing, a tile without a valid entry
//     only writes zeros. Skipping a missing entry per output row instead
//     would leave every warp waiting for its fullest lane; after compaction
//     every lane of a pass has a row.
//   * Work items are (offset, pass): a pass is up to RM * TY compacted rows
//     of one offset (64; 128 where Cin 33..64 meets Cout 64). A thread owns
//     an RM x 8 register block (RM = 4 at Cout 64, 2 at 32, 1 below), so the
//     two 16-byte shared loads of a weight row serve RM rows and one 16-byte
//     load of four inputs serves 8 columns. The block is then added to the
//     tile's fp32 accumulators in shared memory ([128, Cout]), because the
//     rows a thread meets change from offset to offset.
//   * Asynchronous gathers. The rows of item i + 1 arrive by cp.async, 16
//     bytes a piece, into a two-stage ring (rows padded by 4 floats so
//     neighbouring rows fall on different banks) while item i computes, and
//     W[k] travels with an offset's first pass into a ring of its own: one
//     __syncthreads per item. Missing entries are never copied, so the
//     zero-fill form of cp.async is not needed.
//   * W is not kept resident across tiles (a persistent grid): measured on
//     the UNet's shapes, W[k] in the ring was as fast or faster at 8 of 10,
//     and the shared memory buys more CTAs per SM.
//   * Rows >= M are staged as -1 and never stored.
//
// Shared memory per CTA = accumulators 128 * Cout * 4 + gather ring
// 2 * pass * (Cin + 4) * 4 + weight ring 2 * Cin * Cout * 4 + rulebook
// 128 * K3 * 4 + row lists K3 * 128 + counts:
//   K3 27, Cin  8, Cout  8, pass 64:   4,096 +  6,144 +    512 + 17,392 =  28,144 B
//   K3 27, Cin 32, Cout 32, pass 64:  16,384 + 18,432 +  8,192 + 17,392 =  60,400 B
//   K3 27, Cin 32, Cout 64, pass 64:  32,768 + 18,432 + 16,384 + 17,392 =  84,976 B
//   K3 27, Cin 64, Cout 64, pass 128: 32,768 + 69,632 + 32,768 + 17,392 = 152,560 B
//   K3 27, Cin 128, Cout 64, pass 64: 32,768 + 67,584 + 65,536 + 17,392 = 183,280 B
// against 232,448 B a block may take; a request above that fails the launch
// and the wrapper raises. Registers: 54 to 80 by shape, see
// build/torch_kernels/ptxas.log; no spills.
//
// Summation order is fixed (per row: offsets in order, channels in order
// within an offset; no atomics): two launches on the same input give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;            // output rows per CTA, whatever Cout is
constexpr int kPad = 4;               // floats of padding per staged row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// RM x 8 register block per thread; TY threads down the rows, so a pass
// takes RM * TY compacted rows of one kernel offset.
template <int COUT, int RM, int TY>
__global__ void __launch_bounds__(TY * (COUT / 8))
fused_conv_kernel(const float* __restrict__ feats, int n, int cin,
                  const int* __restrict__ rb, int m, int k3,
                  const float* __restrict__ weights, float* __restrict__ out) {
  constexpr int TX = COUT / 8;          // threads across the columns
  constexpr int THREADS = TX * TY;
  constexpr int WARPS = THREADS / 32;
  constexpr int PASS = RM * TY;         // compacted rows per pass
  static_assert(THREADS % 32 == 0 && PASS <= kTile, "whole warps, a pass within the tile");
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = cin + kPad;
  const int q = cin / 4;                // 16-byte pieces per table row
  const int wk = cin * COUT;            // floats of one W[k]
  const int k3p = (k3 + 3) & ~3;
  float* acc_s = reinterpret_cast<float*>(smem);              // [kTile, COUT]
  float* g_s = acc_s + kTile * COUT;                          // 2 x [PASS, pitch]
  float* w_s = g_s + 2 * PASS * pitch;                        // 2 x [cin, COUT]
  int* rb_s = reinterpret_cast<int*>(w_s + 2 * wk);           // [kTile, k3]
  int* cnt_s = rb_s + ((kTile * k3 + 3) & ~3);                // [k3] valid rows per offset
  unsigned char* list_s = reinterpret_cast<unsigned char*>(cnt_s + k3p);  // [k3, kTile] rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int tile0 = blockIdx.x * kTile;
  const int tile_rows = min(kTile, m - tile0);

  // the tile's rulebook rows, once; entries outside the table count as missing
  {
    const int ints = tile_rows * k3;
    const int* src = rb + (size_t)tile0 * k3;
    for (int i = tid; i < kTile * k3; i += THREADS) {
      const int v = i < ints ? src[i] : -1;
      rb_s[i] = v < n ? v : -1;
    }
    for (int i = tid; i < kTile * COUT / 4; i += THREADS)
      reinterpret_cast<float4*>(acc_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // per offset, the tile rows that have a neighbour there, in row order
  for (int k = warp; k < k3; k += WARPS) {
    int count = 0;
    for (int r0 = 0; r0 < kTile; r0 += 32) {
      const bool ok = rb_s[(r0 + lane) * k3 + k] >= 0;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) list_s[k * kTile + count + __popc(mask & ((1u << lane) - 1))] = r0 + lane;
      count += __popc(mask);
    }
    if (lane == 0) cnt_s[k] = count;
  }
  __syncthreads();

  // Work items: (offset k, pass p) over the offsets that have rows. Item i + 1
  // is copied while item i computes; W[k] travels with an offset's first pass.
  auto advance = [&](int& k, int& p) {
    if (++p * PASS >= cnt_s[k]) {
      p = 0;
      do ++k; while (k < k3 && cnt_s[k] == 0);
    }
  };
  auto start_copy = [&](int k, int p, int buf, int wbuf) {
    float* dst = g_s + buf * PASS * pitch;
    const int rows = min(PASS, cnt_s[k] - p * PASS);
    const unsigned char* rows_k = list_s + k * kTile + p * PASS;
    for (int i = tid; i < rows * q; i += THREADS) {
      const int j = i / q, cc = i - j * q;
      const int src = rb_s[rows_k[j] * k3 + k];
      cp_async16(dst + j * pitch + 4 * cc, feats + (size_t)src * cin + 4 * cc);
    }
    if (p == 0) {
      const float* wsrc = weights + (size_t)k * wk;
      float* wdst = w_s + wbuf * wk;
      for (int i = tid; i < wk / 4; i += THREADS) cp_async16(wdst + 4 * i, wsrc + 4 * i);
    }
    cp_async_commit();
  };

  int k = 0, p = 0;
  while (k < k3 && cnt_s[k] == 0) ++k;
  int wsel = 0;                         // weight buffer of offset k
  if (k < k3) start_copy(k, 0, 0, 0);
  for (int it = 0; k < k3; ++it) {
    int k2 = k, p2 = p;
    advance(k2, p2);
    cp_async_wait_all();
    __syncthreads();                    // item `it` landed; item it - 1 is computed
    if (k2 < k3) start_copy(k2, p2, (it + 1) & 1, k2 == k ? wsel : wsel ^ 1);

    const int rows = min(PASS, cnt_s[k] - p * PASS);
    const float* xs = g_s + (it & 1) * PASS * pitch + ty * pitch;
    const float* wc = w_s + wsel * wk + tx * 8;
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (ty < rows) {                    // rows past the count hold stale data
      for (int ci = 0; ci < cin; ci += 4) {
        float4 xv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)    // compacted rows ty, ty + TY, ...
          xv[i] = *reinterpret_cast<const float4*>(xs + i * TY * pitch + ci);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* wr = wc + (ci + j) * COUT;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float x = j == 0 ? xv[i].x : j == 1 ? xv[i].y : j == 2 ? xv[i].z : xv[i].w;
            acc[i][0] = fmaf(x, w0.x, acc[i][0]);
            acc[i][1] = fmaf(x, w0.y, acc[i][1]);
            acc[i][2] = fmaf(x, w0.z, acc[i][2]);
            acc[i][3] = fmaf(x, w0.w, acc[i][3]);
            acc[i][4] = fmaf(x, w1.x, acc[i][4]);
            acc[i][5] = fmaf(x, w1.y, acc[i][5]);
            acc[i][6] = fmaf(x, w1.z, acc[i][6]);
            acc[i][7] = fmaf(x, w1.w, acc[i][7]);
          }
        }
      }
      // add the block to its output rows; one thread owns a (row, columns)
      // piece within an item, and items are a barrier apart
      const unsigned char* rows_k = list_s + k * kTile + p * PASS;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = ty + i * TY;
        if (j < rows) {
          float4* a = reinterpret_cast<float4*>(acc_s + rows_k[j] * COUT + tx * 8);
          float4 a0 = a[0], a1 = a[1];
          a0.x += acc[i][0]; a0.y += acc[i][1]; a0.z += acc[i][2]; a0.w += acc[i][3];
          a1.x += acc[i][4]; a1.y += acc[i][5]; a1.z += acc[i][6]; a1.w += acc[i][7];
          a[0] = a0;
          a[1] = a1;
        }
      }
    }
    if (k2 != k) wsel ^= 1;
    k = k2;
    p = p2;
  }
  __syncthreads();
  {
    const float4* a = reinterpret_cast<const float4*>(acc_s);
    float4* o = reinterpret_cast<float4*>(out + (size_t)tile0 * COUT);
    for (int i = tid; i < tile_rows * (COUT / 4); i += THREADS) o[i] = a[i];
  }
}

template <int COUT, int RM, int TY>
cudaError_t launch(const float* feats, int n, int cin, const int* rb, int m, int k3,
                   const float* weights, float* out, cudaStream_t stream) {
  constexpr int THREADS = TY * (COUT / 8);
  const size_t smem = (size_t)kTile * COUT * 4 + (size_t)2 * RM * TY * (cin + kPad) * 4 +
                      (size_t)2 * cin * COUT * 4 + (size_t)((kTile * k3 + 3) & ~3) * 4 +
                      (size_t)((k3 + 3) & ~3) * 4 + (size_t)k3 * kTile;
  auto kernel = fused_conv_kernel<COUT, RM, TY>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(m + kTile - 1) / kTile, THREADS, smem, stream>>>(feats, n, cin, rb, m, k3,
                                                             weights, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feats [n, cin] fp32, rulebook [m, k3] int32 (-1 = zero row), weights
// [k3, cin, cout] fp32, out [m, cout] fp32. cin % 4 == 0, cin <= 128,
// cout in {8, 16, 32, 64}; feats, weights and out 16-byte aligned. Returns
// the cudaError_t of the launch.
int st_fused_conv(const void* feats, int n, int cin, const void* rulebook,
                  int m, int k3, const void* weights, int cout, void* out,
                  void* stream) {
  if (cin % 4 != 0 || cin <= 0 || cin > 128 || k3 <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const int* rb = static_cast<const int*>(rulebook);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ST_GO(C, R, T) return (int)launch<C, R, T>(f, n, cin, rb, m, k3, w, o, s)
  // pass height: 64 compacted rows keep two CTAs on an SM; Cin 33..64 at
  // Cout 64 takes one CTA of 256 threads and 128-row passes instead
  switch (cout) {
    case 8: ST_GO(8, 1, 64);
    case 16: ST_GO(16, 1, 32);
    case 32: ST_GO(32, 2, 32);
    case 64:
      if (cin > 32 && cin <= 64) ST_GO(64, 4, 32);
      ST_GO(64, 4, 16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ST_GO
}

}  // extern "C"
