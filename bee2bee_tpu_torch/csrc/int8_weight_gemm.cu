// The int8-weight GEMM of the serving forward: y[M, N] = (x[M, K] @ q[K, N])
// * s[N], q int8 (weight-only quantized, models/quant.py), s f32 per output
// channel, the sum in f32, x and y in the activations' type: bf16, or f32
// (the f32 form, below). M is a root's token count: 1-8 at decode, B*(K+1)
// at a speculative verify, up to 64 here (the wrapper sends wider chunks to
// a dequantize + cuBLAS product, ops/int8_gemm.py).
//
// What it replaces. No TPU kernel: the JAX package's core.matmul computes
// (x @ q.astype(x.dtype)) * s and XLA fuses the int8 -> bf16 convert into
// the dot's operand read, so the weights leave HBM as int8. The same line in
// PyTorch writes a bf16 copy of every weight on every call and reads it
// back, about three times the traffic int8 was meant to halve. This kernel
// reads each int8 weight byte once per call, for all M rows, and writes no
// bf16 copy.
//
// What bounds it. At M <= 64 the bytes: K*N int8 + 4N scale bytes + 2MK + 2MN
// over 3.35 TB/s (llama-3-8b w_up at M = 8: 58.8 MB, 17.5 us). The
// operations (2MKN) sit two orders of magnitude under the bf16 tensor-core
// peak.
//
// What the design does about it.
//   - Tensor cores with the WEIGHT as operand A: mma.m16n8k16 takes a tile
//     of 16 output channels x 16 inputs as A and x^T (16 inputs x 8 tokens)
//     as B, so M <= 8 fills the n8 side exactly and wider M loops the n8
//     tiles over one A fragment held in registers.
//   - The weight is repacked once at load (ops/int8_gemm.py pack_weight)
//     into fragment order: a 16-channel x 32-input chunk is 512 contiguous
//     bytes, 16 a lane, so one coalesced 16-byte load gives a lane its A
//     fragments for two k16 steps. The inputs of a chunk are permuted so
//     that a lane's B fragments for both steps are 8 CONSECUTIVE inputs of
//     one token: one 16-byte load of x (the same permutation on A and B
//     leaves the dot unchanged).
//   - Each warp streams its chunks through a ring of loads in flight (16
//     deep on the staged path, 8 otherwise; ld.global.nc, no L1
//     allocation: each byte is read once).
//   - The activations. Up to 16 tokens (decode), the block stages its K
//     range of x in shared memory once (cp.async, issued behind the
//     weight ring's first loads), so a chunk's B fragments are a 16-byte
//     shared load, not a trip to L2 the four warps wait on; rows are
//     padded so that two token rows of a load phase fall in different
//     banks. Wider M (verify chunks) reads x through the read-only cache,
//     shared by the block's four warps (the same inputs, four channel
//     tiles).
//   - int8 -> bf16 by a byte permute into the 2^23 magic float and one
//     subtract (exact for |q| <= 127), then cvt.rn.bf16x2.f32; I2F would
//     run at a quarter of the rate.
//   - The per-channel scale is applied in the epilogue, once per output.
//   - The f32 form (f32 x and y: an f32 engine with int8 weights) keeps
//     the packed layout, the ring, the staging and the split-K, and runs
//     the products as 2xTF32 on mma.m16n8k8. Every int8 value is exact in
//     TF32, so only x is split, x = hi + lo (both TF32; lo rounds away
//     x's last 2-3 bits of 24): two products a step, the small one first.
//     Four k8 steps cover a lane's 16 bytes: step s takes its word s,
//     whose bytes are (channel g, input 2s), (g, 2s + 1), (g + 8, 2s),
//     (g + 8, 2s + 1) of its 8 inputs, as A's k = t and k = t + 4, so B's
//     fragments are inputs 2s and 2s + 1 of the lane's 8 consecutive x
//     values (two 16-byte loads). The x rows staged in shared memory are
//     128 bytes a chunk, padded to 16 mod 128 bytes a row (the two token
//     rows of a load phase in other banks). Bound: bytes K*N + 4N + 4MK +
//     4MN (llama-3-8b w_up at M = 8: 59.4 MB, 17.7 us at the H100 SXM's
//     data-sheet 3.35 TB/s); the products (2 * 2MKN at the TF32 peak) stay
//     under it up to M of about 40. FFMA was the other design: at the
//     verify width (M = 40) w_up's 4.7 GFLOP would take about 0.07 ms at
//     the data sheet's 67 TFLOP/s, four times the bytes' bound.
//   - One launch for up to three weights that share x (wq, wk and wv; w_up
//     and w_gate): the grid is their channel groups one after the other,
//     so a layer takes 4 launches, not 7.
//   - Split-K without float atomics: the cs blocks of a thread block
//     cluster take consecutive K ranges of the same 64 channels and reduce
//     their partials through distributed shared memory in rank order, so
//     the result is the same bit for bit on every run (a replayed CUDA
//     graph and the eager step agree). The plan (cs, chunks a block) is a
//     function of host shapes only (ops/int8_gemm.py gemm_plan), so a
//     captured graph keeps it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;             // channel tiles a block (64 channels)
constexpr int kThreads = kWarps * 32;
// weight loads in flight a lane: 16 on the staged path (few registers
// besides), 8 where x comes through the cache (up to 8 token tiles of
// accumulators)
template <bool STAGED>
constexpr int kRing = STAGED ? 16 : 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_cached(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory, asynchronous; with src_bytes
// 0 nothing is read and the slot is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// up to three weights of one launch (the same x and K): their packed bytes,
// scales, outputs (in x's type), widths and channel groups of 64
constexpr int kMaxWeights = 3;
struct Weights {
  const int8_t* qp[kMaxWeights];
  const float* s[kMaxWeights];
  void* y[kMaxWeights];
  int N[kMaxWeights];
  int groups[kMaxWeights];
  int count;
};

// the staged x row stride in bytes for ``per`` chunks of 32 inputs, so the
// two token rows one 8-lane phase of a 16-byte load reads sit in different
// banks: bf16 (64-byte chunks) 64 mod 128; f32 (128-byte chunks, a lane
// reading 32 bytes at t * 32) 16 mod 128
template <typename XT>
__host__ __device__ __forceinline__ int staged_row_bytes(int per) {
  if constexpr (sizeof(XT) == 4) {
    return per * 128 + 16;
  } else {
    return per * 64 + ((per & 1) ? 0 : 64);
  }
}

// two int8 bytes of w (byte index lo, lo + 1) -> bf16x2, exactly: u = q + 128
// lands in the low byte of 2^23 (0x4B0000uu), minus 2^23 + 128 gives q
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t u, int lo) {
  uint32_t f0, f1;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(f0) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | lo));
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(f1) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | (lo + 1)));
  const float a = __uint_as_float(f0) - 8388736.0f;
  const float b = __uint_as_float(f1) - 8388736.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one packed chunk (16 bytes of this lane) -> the A fragments of its two
// k16 steps. Bytes of a word: (row g, k), (row g, k+1), (row g+8, k),
// (row g+8, k+1); words 0-1 are step 0, words 2-3 step 1
__device__ __forceinline__ void chunk_fragments(const uint4& w, uint32_t (&a0)[4],
                                                uint32_t (&a1)[4]) {
  const uint32_t u0 = w.x ^ 0x80808080u, u1 = w.y ^ 0x80808080u;
  const uint32_t u2 = w.z ^ 0x80808080u, u3 = w.w ^ 0x80808080u;
  a0[0] = i8x2_to_bf16x2(u0, 0);
  a0[1] = i8x2_to_bf16x2(u0, 2);
  a0[2] = i8x2_to_bf16x2(u1, 0);
  a0[3] = i8x2_to_bf16x2(u1, 2);
  a1[0] = i8x2_to_bf16x2(u2, 0);
  a1[1] = i8x2_to_bf16x2(u2, 2);
  a1[2] = i8x2_to_bf16x2(u3, 0);
  a1[3] = i8x2_to_bf16x2(u3, 2);
}

// one int8 byte (index idx of u, already XORed with 0x80) -> its f32 value
// as a TF32 operand, exactly (the byte permute of i8x2_to_bf16x2)
__device__ __forceinline__ uint32_t i8_to_tf32(uint32_t u, int idx) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(f) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | idx));
  return __float_as_uint(__uint_as_float(f) - 8388736.0f);
}

// one packed chunk (16 bytes of this lane) -> the TF32 A fragments of its
// four k8 steps: step s reads word s, whose bytes are (row g, input 2s),
// (row g, 2s + 1), (row g + 8, 2s), (row g + 8, 2s + 1); A's k = t takes
// input 2s, k = t + 4 input 2s + 1
__device__ __forceinline__ void chunk_fragments_tf32(const uint4& w, uint32_t (&a)[4][4]) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = i8_to_tf32(u[s], 0);
    a[s][1] = i8_to_tf32(u[s], 2);
    a[s][2] = i8_to_tf32(u[s], 1);
    a[s][3] = i8_to_tf32(u[s], 3);
  }
}

// x = hi + lo, both TF32 (cvt.rna's rounding by bit arithmetic, as
// tile_attention_f32.cuh splits: hi drops its 13 low bits itself, the
// tensor cores ignore lo's)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b for one 16x8 f32 tile: a 16x8 TF32 (row), b 8x8 TF32 (col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid: (sum of the weights' ceil(N / 64)) * cs blocks in clusters of cs;
// cluster c owns channel group c of the weights laid end to end, block b
// its channel tiles 4 * group .. + 3 (one a warp) over input chunks [rank *
// per, (rank + 1) * per) of the Kc = K / 32. NT = ceil(M / 8) token tiles;
// STAGED: x's K range in dynamic shared memory (NT * 8 rows of
// staged_row_bytes(per)). XT: x's and y's type, bf16 or float (the 2xTF32
// form).
template <int NT, bool STAGED, typename XT>
__global__ void __launch_bounds__(kThreads)
int8_weight_gemm_kernel(const XT* __restrict__ x, const Weights W, int M, int K, int cs,
                        int per) {
  constexpr bool kF32 = std::is_same<XT, float>::value;
  // 16-byte pieces of one token's 32-input chunk, and the chunk's bytes
  constexpr int kPieces = 32 * sizeof(XT) / 16;
  constexpr int kChunkBytes = 32 * sizeof(XT);
  __shared__ float red[kWarps * NT * 4 * 32];
  extern __shared__ __align__(16) unsigned char xs[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this cluster's weight and channel group (uniform across the block),
  // picked with constant indices: a runtime index into the parameter
  // struct would copy it to local memory
  int grp = blockIdx.x / cs;
  const int8_t* qp = W.qp[0];
  const float* s = W.s[0];
  void* y = W.y[0];
  int N = W.N[0];
  if (W.count > 1 && grp >= W.groups[0]) {
    grp -= W.groups[0];
    qp = W.qp[1], s = W.s[1], y = W.y[1], N = W.N[1];
    if (W.count > 2 && grp >= W.groups[1]) {
      grp -= W.groups[1];
      qp = W.qp[2], s = W.s[2], y = W.y[2], N = W.N[2];
    }
  }
  const int Kc = K >> 5, Nt = (N + 15) >> 4;
  const int nt = grp * kWarps + warp;
  const int kb = rank * per;
  const int ke = min(Kc, kb + per);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int8_t* wp = qp + ((static_cast<size_t>(nt) * Kc) * 32 + lane) * 16;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  constexpr int R = kRing<STAGED>;
  uint4 ring[R];
  if (nt < Nt && kb < ke) {
#pragma unroll
    for (int u = 0; u < R; ++u)
      ring[u] = kb + u < ke ? ld_stream(wp + static_cast<size_t>(kb + u) * 512) : zero;
  }
  const int row_bytes = staged_row_bytes<XT>(per);
  if constexpr (STAGED) {
    // x rows [0, NT * 8) x chunks [kb, ke) into shared memory, 16 bytes a
    // copy (rows past M and chunks past Kc zero-filled), behind the ring
    const int pieces = NT * 8 * per * kPieces;
    for (int i = threadIdx.x; i < pieces; i += kThreads) {
      const int row = i / (per * kPieces), rest = i % (per * kPieces);
      const int c = kb + rest / kPieces, piece = rest % kPieces;
      const bool real = row < M && c < ke;
      const XT* src = real ? x + static_cast<size_t>(row) * K + c * 32
                                 + piece * static_cast<int>(16 / sizeof(XT))
                           : x;
      cp_async16(xs + row * row_bytes + rest * 16, src, real ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (nt < Nt && kb < ke) {
    for (int c0 = kb; c0 < ke; c0 += R) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int c = c0 + u;
        if (c < ke) {
          if constexpr (kF32) {
            uint32_t a[4][4];
            chunk_fragments_tf32(ring[u], a);
            if (c + R < ke) ring[u] = ld_stream(wp + static_cast<size_t>(c + R) * 512);
            // this lane's 8 inputs of token j * 8 + g (two 16-byte loads):
            // inputs 2s and 2s + 1 are step s's B fragments
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int tok = j * 8 + g;
              uint4 x0, x1;
              if constexpr (STAGED) {
                const unsigned char* p = xs + tok * row_bytes + (c - kb) * kChunkBytes + t * 32;
                x0 = *reinterpret_cast<const uint4*>(p);
                x1 = *reinterpret_cast<const uint4*>(p + 16);
              } else {
                const XT* p = x + static_cast<size_t>(tok) * K + c * 32 + t * 8;
                x0 = tok < M ? ld_cached(p) : zero;
                x1 = tok < M ? ld_cached(p + 4) : zero;
              }
              const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
              for (int st = 0; st < 4; ++st) {
                uint32_t h0, l0, h1, l1;
                split_tf32(__uint_as_float(xw[2 * st]), h0, l0);
                split_tf32(__uint_as_float(xw[2 * st + 1]), h1, l1);
                mma_tf32(acc[j], a[st], l0, l1);
                mma_tf32(acc[j], a[st], h0, h1);
              }
            }
          } else {
            uint32_t a0[4], a1[4];
            chunk_fragments(ring[u], a0, a1);
            if (c + R < ke) ring[u] = ld_stream(wp + static_cast<size_t>(c + R) * 512);
            // this lane's 8 inputs of token j * 8 + g: both steps' B fragments
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int tok = j * 8 + g;
              uint4 xv;
              if constexpr (STAGED) {
                xv = *reinterpret_cast<const uint4*>(xs + tok * row_bytes +
                                                     (c - kb) * kChunkBytes + t * 16);
              } else {
                xv = tok < M ? ld_cached(x + static_cast<size_t>(tok) * K + c * 32 + t * 8)
                             : zero;
              }
              mma_bf16(acc[j], a0, xv.x, xv.y);
              mma_bf16(acc[j], a1, xv.z, xv.w);
            }
          }
        }
      }
    }
  }

  // partials into this block's shared memory, [warp][j][e][lane]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[((warp * NT + j) * 4 + e) * 32 + lane] = acc[j][e];
  cluster.sync();

  // rank r reduces every cs-th element, over the cluster's ranks in order
  constexpr int kTotal = kWarps * NT * 4 * 32;
  for (int i = rank * kThreads + threadIdx.x; i < kTotal; i += cs * kThreads) {
    const int l = i & 31, e = (i >> 5) & 3, j = (i >> 7) % NT, w = (i >> 7) / NT;
    const int ch = (grp * kWarps + w) * 16 + (l >> 2) + 8 * (e >> 1);
    const int tok = j * 8 + 2 * (l & 3) + (e & 1);
    float sum = 0.f;
    for (int src = 0; src < cs; ++src) sum += cluster.map_shared_rank(red, src)[i];
    if (tok < M && ch < N) {
      const size_t at = static_cast<size_t>(tok) * N + ch;
      if constexpr (kF32) {
        static_cast<float*>(y)[at] = sum * s[ch];
      } else {
        static_cast<bf16*>(y)[at] = __float2bfloat16_rn(sum * s[ch]);
      }
    }
  }
  // no block leaves while another still reads its shared memory
  cluster.sync();
}

// the largest staged x a block holds (dynamic shared memory)
constexpr int kMaxStagedBytes = 96 * 1024;

template <int NT, bool STAGED, typename XT>
cudaError_t launch(const XT* x, const Weights& W, int M, int K, int cs, int per,
                   cudaStream_t stream) {
  auto kernel = int8_weight_gemm_kernel<NT, STAGED, XT>;
  size_t smem = 0;
  if constexpr (STAGED) {
    // once per instantiation: the attribute outlives the call
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStagedBytes);
    if (attr != cudaSuccess) return attr;
    smem = static_cast<size_t>(NT) * 8 * staged_row_bytes<XT>(per);
  }
  cudaLaunchConfig_t cfg = {};
  int groups = 0;
  for (int i = 0; i < W.count; ++i) groups += W.groups[i];
  cfg.gridDim = dim3(groups * cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, W, M, K, cs, per);
}

// x's type: the tile counts of M, each with its staged form where x's K
// range fits shared memory
template <typename XT>
cudaError_t dispatch(const XT* x, const Weights& W, int M, int K, int cs, int per,
                     cudaStream_t st) {
  // up to 2 token tiles, x staged in shared memory when its K range fits
  const int tiles = (M + 7) / 8;
  const bool staged = tiles <= 2 && tiles * 8 * staged_row_bytes<XT>(per) <= kMaxStagedBytes;
  switch (tiles) {
    case 1:
      return staged ? launch<1, true>(x, W, M, K, cs, per, st)
                    : launch<1, false>(x, W, M, K, cs, per, st);
    case 2:
      return staged ? launch<2, true>(x, W, M, K, cs, per, st)
                    : launch<2, false>(x, W, M, K, cs, per, st);
    case 3: return launch<3, false>(x, W, M, K, cs, per, st);
    case 4: return launch<4, false>(x, W, M, K, cs, per, st);
    case 5: return launch<5, false>(x, W, M, K, cs, per, st);
    // 6 tiles: ptxas (CUDA 12.9) spilled the bf16 instantiation's registers
    // (8 bytes); M in 41..48 runs the 7-tile form, its 7th tile masked
    case 6:
    case 7: return launch<7, false>(x, W, M, K, cs, per, st);
    default: return launch<8, false>(x, W, M, K, cs, per, st);
  }
}

}  // namespace

// y_i [M, N_i] = (x [M, K] @ unpack(qp_i)) * s_i [N_i] f32 for the count
// (1..3) weights given, in one launch; x and y_i bf16 (dtype 1) or f32
// (dtype 0, the 2xTF32 form); qp_i the packed int8 weight [N_i / 16, K /
// 32, 32, 16]. M in 1..64, K % 32 == 0, cs in 1..8 (a cluster), per =
// chunks a cluster rank takes. Returns the CUDA error of the launch (0 =
// launched).
extern "C" int b2b_int8_weight_gemm(const void* x, int dtype, int count, const void* qp0,
                                    const void* s0, void* y0, int N0, const void* qp1,
                                    const void* s1, void* y1, int N1, const void* qp2,
                                    const void* s2, void* y2, int N2, int M, int K, int cs,
                                    int per, void* stream) {
  if (M < 1 || M > 64 || K % 32 != 0 || cs < 1 || cs > 8 || per < 1 || count < 1 ||
      count > kMaxWeights || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* qps[kMaxWeights] = {qp0, qp1, qp2};
  const void* ss[kMaxWeights] = {s0, s1, s2};
  void* ys[kMaxWeights] = {y0, y1, y2};
  const int Ns[kMaxWeights] = {N0, N1, N2};
  Weights W = {};
  W.count = count;
  for (int i = 0; i < count; ++i) {
    if (Ns[i] < 1 || Ns[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    W.qp[i] = static_cast<const int8_t*>(qps[i]);
    W.s[i] = static_cast<const float*>(ss[i]);
    W.y[i] = ys[i];
    W.N[i] = Ns[i];
    W.groups[i] = (Ns[i] + 63) / 64;
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
                        ? dispatch(static_cast<const bf16*>(x), W, M, K, cs, per, st)
                        : dispatch(static_cast<const float*>(x), W, M, K, cs, per, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
