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
// the feature table.
//
// What bounds it. At the UNet's shapes (Cin 8..64, Cout 8..64) one output
// row costs 2 * 27 * Cin * Cout operations against 27 * 4 bytes of rulebook,
// Cin * 4 bytes of table and Cout * 4 bytes of output: at the bf16
// tensor-core rate the ideal kernel is bound by device-memory bytes. The
// design therefore reads the rulebook once, the table about once (slabs of
// neighbouring tiles overlap little), and keeps everything else on chip.
//
// Design. One CTA of 4 warps computes a tile of kTile = 128 output rows and
// ALL of Cout, whatever Cout is; a warp owns 32 rows (two m16 tiles).
//   * Bounds in the kernel. The CTA loads its [128, 27] raw rulebook rows into
//     shared memory once (rows >= M read as -1) and each warp reduces, per
//     group, the first and last referenced table row: the slab starts at the
//     first row rounded down to `blk` rows, spans up to the last, and is
//     walked in chunks of `slab` rows -- exactly the contract of
//     core/slab_conv.py::_precompute, which nothing computes on the host any
//     more.
//   * Tensor cores with a gathered A operand. K runs over (rulebook column,
//     channel). Each 8-wide K slice lies in one column, i.e. in one staged
//     slab row, and ldmatrix takes one shared-memory row address per lane, so
//     the lanes pass the gathered rows `slab + rel * pitch` directly: no
//     one-hot product, no compaction. A missing entry (-1, or outside the
//     chunk) points at a zeroed row. mma.sync.m16n8k16 (bf16 x bf16 -> fp32)
//     accumulates in registers. A group holds 3 * Cin / 8 slices; where that
//     is odd (Cin 8, 24, ...) the last k16 step is padded with a zero slice.
//     A warp whose 32 rows read nothing from a (group, chunk) skips it.
//   * Weights are rounded to bf16 (round to nearest even) once per call by a
//     small first kernel that also lays them out as the B fragments want
//     ([group][k16 step][n tile][lane] x 8 bytes, so a warp's fragment load is
//     256 contiguous bytes); the main kernel copies one group's fragments per
//     work item with cp.async into a two-stage ring.
//   * Overlap. A work item is one (group, chunk). While item i computes,
//     cp.async brings item i+1's slab (fp32, one contiguous piece of the
//     table) and weight fragments; at the top of an item the fp32 stage is
//     rounded to bf16 (nearest even) into the operand slab, shared to shared.
//     Two __syncthreads per item. (A deeper ring of copies, three items ahead,
//     was measured and gained nothing: the chain of items per tile, not the
//     copy latency, is what a tile waits for.)
//   * Slab row pitch is Cin (+8 if Cin/8 is even) bf16, an odd number of
//     16-byte units, so consecutive rows fall on distinct bank groups for
//     ldmatrix. Output goes out as 16-byte stores after one shuffle between
//     neighbouring lanes; rows >= M are masked.
//
// Shared memory per CTA = rulebook 13,824 B + bounds/zero row 272 B +
// 2 x weights (steps * Cout * 32 B, steps = ceil(3 * Cin / 16)) +
// fp32 stage (slab * Cin * 4) + bf16 slab (slab * pitch * 2). The caller
// passes slab = 256 up to Cin 32 and 128 at Cin 64:
//   Cin  8, Cout 64:  14,096 +  8,192 +  8,192 +  4,096 =  34,576 B (6 CTAs/SM)
//   Cin 16, Cout 64:  14,096 + 12,288 + 16,384 + 12,288 =  55,056 B (4 CTAs/SM)
//   Cin 32, Cout 64:  14,096 + 24,576 + 32,768 + 20,480 =  91,920 B (2 CTAs/SM)
//   Cin 64, Cout 64:  14,096 + 49,152 + 32,768 + 18,432 = 114,448 B (1 CTA/SM;
//                     Cout 32: 89,872 B, 2 CTAs/SM)
// against 232,448 B a block may take. Registers (128 threads): 40 to 93 by
// Cout, see build/torch_kernels/ptxas.log; no spills. Accumulators are Cout
// per thread.
//
// No atomics touch the output: two launches on the same input give the same
// bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // output rows per CTA, whatever Cout is
constexpr int kWarps = 4;     // each owns kTile / kWarps = 32 rows: two m16 tiles
constexpr int kMT = kTile / kWarps / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kK3 = 27;
constexpr int kMaxPitchBytes = 144;   // zero row: one slab row at Cin 64

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__host__ __device__ inline int k16_steps(int cin) { return (3 * cin + 15) / 16; }
__host__ __device__ inline int pitch_elems(int cin) { return ((cin / 8) & 1) ? cin : cin + 8; }

// Weights [27, cin, cout] fp32 -> bf16 B fragments of mma.m16n8k16,
// [9 groups][steps][cout / 8][32 lanes] x uint2. Lane l of n tile j holds
// B[k][n] for n = 8 j + l / 4 and k = 16 step + 2 (l % 4) + {0, 1} (.x) and
// the same + 8 (.y); k indexes the group's [3 * cin] rows, zero past them.
__global__ void slab_weight_fragments(const float* __restrict__ w, int cin, int cout,
                                      uint2* __restrict__ frag) {
  const int steps = k16_steps(cin);
  const int nt = cout / 8;
  const int total = 9 * steps * nt * 32;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int lane = i & 31;
    const int j = (i >> 5) % nt;
    const int step = (i >> 5) / nt % steps;
    const int g = (i >> 5) / nt / steps;
    const int n = 8 * j + lane / 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 16 * step + 2 * (lane % 4) + (e >> 1) * 8 + (e & 1);
      v[e] = kk < 3 * cin ? w[((size_t)(3 * g) * cin + kk) * cout + n] : 0.f;
    }
    frag[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

template <int COUT>
__global__ void __launch_bounds__(kThreads)
slab_conv_kernel(const float* __restrict__ feats, int n, int cin,
                 const int* __restrict__ rb, int m,
                 const uint2* __restrict__ wfrag, float* __restrict__ out,
                 int slab, int blk) {
  constexpr int MT = kMT;
  constexpr int NT = COUT / 8;
  constexpr int THREADS = kThreads;
  constexpr int WARPS = kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int steps = k16_steps(cin);
  const int c8 = cin / 8;
  const int pitch_b = pitch_elems(cin) * 2;               // slab row pitch, bytes
  const int wbytes = steps * COUT * 32;                   // one group's fragments
  int* rb_s = reinterpret_cast<int*>(smem);               // [kTile, 27]
  int* start_s = rb_s + kTile * kK3;                      // [9] first slab row
  int* span_s = start_s + 16;                             // [9] rows referenced
  unsigned char* zero_s = reinterpret_cast<unsigned char*>(start_s + 32);
  unsigned char* w_s = zero_s + kMaxPitchBytes;           // 2 x wbytes
  float* stage_s = reinterpret_cast<float*>(w_s + 2 * wbytes);    // [slab, cin] fp32
  unsigned char* slab_s = reinterpret_cast<unsigned char*>(stage_s) + (size_t)slab * cin * 4;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile;

  // the tile's raw rulebook rows, once
  {
    const int ints = min(kTile, m - tile0) * kK3;
    const int* src = rb + (size_t)tile0 * kK3;
    if (ints == kTile * kK3) {
      const int4* src4 = reinterpret_cast<const int4*>(src);
      int4* dst4 = reinterpret_cast<int4*>(rb_s);
      for (int i = tid; i < kTile * kK3 / 4; i += THREADS) dst4[i] = src4[i];
    } else {
      for (int i = tid; i < kTile * kK3; i += THREADS) rb_s[i] = i < ints ? src[i] : -1;
    }
    for (int i = tid; i < kMaxPitchBytes / 4; i += THREADS)
      reinterpret_cast<int*>(zero_s)[i] = 0;
  }
  __syncthreads();
  // slab bounds per group: first row (rounded down to blk) and rows spanned
  for (int g = warp; g < 9; g += WARPS) {
    int mn = INT32_MAX, mx = -1;
    for (int i = lane; i < kTile * 3; i += 32) {
      const int e = rb_s[(i / 3) * kK3 + 3 * g + i % 3];
      if (e >= 0) mn = min(mn, e);
      mx = max(mx, e);
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) {
      const int start = mx >= 0 ? (mn / blk) * blk : 0;
      start_s[g] = start;
      span_s[g] = mx >= 0 ? mx - start + 1 : 0;
    }
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

  // work items (group, chunk) in order; empty groups have none
  int g = 0, c = 0;
  while (g < 9 && span_s[g] == 0) ++g;

  auto item_rows = [&](int gg, int cc) {
    const int base = start_s[gg] + cc * slab;
    return min(min(slab, span_s[gg] - cc * slab), n - base);
  };
  auto start_copy = [&](int gg, int cc, int buf) {
    const int base = start_s[gg] + cc * slab;
    const int pieces = item_rows(gg, cc) * cin / 4;       // 16-byte pieces
    const float4* src = reinterpret_cast<const float4*>(feats + (size_t)base * cin);
    float4* dst = reinterpret_cast<float4*>(stage_s);
    for (int i = tid; i < pieces; i += THREADS) cp_async16(dst + i, src + i);
    const uint4* wsrc = reinterpret_cast<const uint4*>(
        reinterpret_cast<const unsigned char*>(wfrag) + (size_t)gg * wbytes);
    uint4* wdst = reinterpret_cast<uint4*>(w_s + buf * wbytes);
    for (int i = tid; i < wbytes / 16; i += THREADS) cp_async16(wdst + i, wsrc + i);
    cp_async_commit();
  };

  if (g < 9) start_copy(g, 0, 0);
  cp_async_wait_all();
  __syncthreads();

  const uint32_t slab_a = smem_u32(slab_s);
  const uint32_t zero_a = smem_u32(zero_s);
  const int khalf = lane >> 4;
  for (int it = 0; g < 9; ++it) {
    // the item after this one
    int g2 = g, c2 = c + 1;
    if (c2 * slab >= span_s[g]) {
      c2 = 0;
      ++g2;
      while (g2 < 9 && span_s[g2] == 0) ++g2;
    }
    const int base = start_s[g] + c * slab;
    const int rows = item_rows(g, c);

    // fp32 stage -> bf16 operand slab (round to nearest even)
    {
      const int c4 = cin / 4;
      const float4* src = reinterpret_cast<const float4*>(stage_s);
      for (int i = tid; i < rows * c4; i += THREADS) {
        const int rr = i / c4, cc = i - rr * c4;
        const float4 v = src[i];
        *reinterpret_cast<uint2*>(slab_s + rr * pitch_b + cc * 8) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    }
    __syncthreads();                  // slab ready, stage free
    if (g2 < 9) start_copy(g2, c2, (it + 1) & 1);

    // this lane's gathered row addresses: output row (lane & 15) of each of
    // the warp's MT m-tiles, for the group's three columns
    uint32_t rowa[MT][3];
    bool any = false;
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      const int r = (warp * MT + a) * 16 + (lane & 15);
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int e = rb_s[r * kK3 + 3 * g + dz];
        const int rl = e - base;
        const bool ok = e >= 0 && rl >= 0 && rl < rows;
        rowa[a][dz] = ok ? slab_a + rl * pitch_b : zero_a;
        any |= ok;
      }
    }
    if (__any_sync(0xffffffffu, any)) {   // else the warp's rows read nothing here
      const uint2* wf = reinterpret_cast<const uint2*>(w_s + (it & 1) * wbytes) + lane;
      int dz = 0, ch8 = khalf;            // this lane's 8-wide K slice
      while (ch8 >= c8) { ch8 -= c8; ++dz; }
      for (int s = 0; s < steps; ++s) {
        uint32_t afrag[MT][4];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          const uint32_t ra = dz == 0 ? rowa[a][0] : dz == 1 ? rowa[a][1]
                              : dz == 2 ? rowa[a][2] : zero_a;
          ldmatrix_x4(afrag[a], ra + ch8 * 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = wf[(s * NT + j) * 32];
#pragma unroll
          for (int a = 0; a < MT; ++a) mma_bf16(acc[a][j], afrag[a], b);
        }
        ch8 += 2;
        while (ch8 >= c8) { ch8 -= c8; ++dz; }
      }
    }
    cp_async_wait_all();
    __syncthreads();                  // next item landed; slab and weights free
    g = g2;
    c = c2;
  }

  // accumulators: c0 c1 = (row lane / 4, cols 2 (lane % 4) + {0, 1}), c2 c3 the
  // same 8 rows down. Even lanes trade with their odd neighbour so that each
  // lane stores 16 bytes.
  const int q = lane & 3;
  const bool odd = q & 1;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int row = tile0 + (warp * MT + a) * 16 + (lane >> 2) + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float s0 = odd ? acc[a][j][0] : acc[a][j][2];
      const float s1 = odd ? acc[a][j][1] : acc[a][j][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, acc[a][j][2], acc[a][j][3])
                           : make_float4(acc[a][j][0], acc[a][j][1], r0, r1);
      if (row < m)
        *reinterpret_cast<float4*>(out + (size_t)row * COUT + 8 * j + (q >> 1) * 4) = v;
    }
  }
}

size_t smem_bytes(int cin, int cout, int slab) {
  return (size_t)kTile * kK3 * 4 + 32 * 4 + kMaxPitchBytes +
         2 * (size_t)k16_steps(cin) * cout * 32 + (size_t)slab * cin * 4 +
         (size_t)slab * pitch_elems(cin) * 2;
}

template <int COUT>
cudaError_t launch(const float* feats, int n, int cin, const int* rb, int m,
                   const float* weights, uint2* wfrag, float* out, int slab, int blk,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(cin, COUT, slab);
  cudaError_t err = cudaFuncSetAttribute(
      slab_conv_kernel<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int frags = 9 * k16_steps(cin) * (COUT / 8) * 32;
  slab_weight_fragments<<<(frags + 255) / 256, 256, 0, stream>>>(weights, cin, COUT, wfrag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slab_conv_kernel<COUT><<<(m + kTile - 1) / kTile, kThreads, smem, stream>>>(
      feats, n, cin, rb, m, wfrag, out, slab, blk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output rows per CTA (the same for every Cout).
int st_slab_conv_tile() { return kTile; }

// Bytes of scratch the caller allocates for the bf16 weight fragments.
int st_slab_conv_scratch_bytes(int cin, int cout) {
  return 9 * k16_steps(cin) * cout * 32;
}

// feats [n, cin] fp32, rulebook [m, 27] int32 (raw: table rows, -1 = none;
// columns monotone), weights [27, cin, cout] fp32, scratch of
// st_slab_conv_scratch_bytes(cin, cout) bytes, out [m, cout] fp32; slab =
// table rows per staged chunk, blk = slab start alignment in rows.
// cin % 8 == 0, cin <= 64, cout in {8, 16, 32, 64}; all pointers 16-byte
// aligned. Returns the cudaError_t of the launch.
int st_slab_conv(const void* feats, int n, int cin, const void* rulebook, int m,
                 const void* weights, int cout, void* scratch, void* out, int slab,
                 int blk, void* stream) {
  if (cin % 8 != 0 || cin <= 0 || cin > 64 || slab <= 0 || blk <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  const int* rb = static_cast<const int*>(rulebook);
  const float* w = static_cast<const float*>(weights);
  uint2* wf = static_cast<uint2*>(scratch);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: return (int)launch<8>(f, n, cin, rb, m, w, wf, o, slab, blk, s);
    case 16: return (int)launch<16>(f, n, cin, rb, m, w, wf, o, slab, blk, s);
    case 32: return (int)launch<32>(f, n, cin, rb, m, w, wf, o, slab, blk, s);
    case 64: return (int)launch<64>(f, n, cin, rb, m, w, wf, o, slab, blk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
