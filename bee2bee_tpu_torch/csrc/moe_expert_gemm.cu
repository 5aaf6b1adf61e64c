// The routed expert product of a mixture-of-experts layer: for every kept
// assignment a of a token to an expert, in the plan's sorted order (rows of
// one expert contiguous),
//   y[a, :] = x[tok[a], :] @ W[e(a)]            (x's type experts)
//   y[a, :] = (x[tok[a], :] @ q[e(a)]) * s[e(a)] (int8 experts, f32 scales
//                                                 per expert and channel)
// with W / q the JAX layout [E, K, N] (models/core.py: [E, in, out]), the
// sum in f32 and y in x's type: bf16 or f32. ``tok`` may be null (the rows
// of x are the sorted assignments themselves: the down product over h).
//
// What it replaces. No TPU kernel: the JAX package's _moe computes every
// expert on every token with XLA einsums and masks the unpicked ones with
// weight 0 (its _moe_routed packs capacity buffers with one-hot einsums).
// It was added for two reasons. The dense formula does E/k of the useful
// work (16x for qwen3-30b-a3b, 4x for mixtral-8x7b) and its [N, E, D]
// intermediate alone is about a gigabyte a layer at a 2,048-token chunk;
// and PyTorch has no int8-weight product for 3-D expert stacks, so int8
// experts would be dequantized into a bf16 scratch of 2.8 GB a layer
// (mixtral). A grouped product runs each expert only on the rows routed to
// it, reads int8 experts as int8, and keeps every shape static: the rows of
// each expert and the tile map are counted on the device by the plan
// (ops/moe.py), so a root that runs it is captured as a CUDA graph.
//
// What bounds it. At decode (a handful of rows an expert) the bytes of the
// distinct experts the step touches: qwen3-30b-a3b at B = 8 reads about 52
// of 128 experts, 0.49 GB a layer; mixtral-8x7b about 7.2 of 8 int8
// experts, 1.27 GB a layer (3.35 TB/s: 0.15 and 0.38 ms). At a prefill
// chunk the routed products: 2 * A * K * N for A assignments (mixtral at
// 2,048 tokens: 1.4 TFLOP a layer of gate, up and down, 1.5 ms at the bf16
// peak of 989 TFLOP/s), while qwen3's experts stay byte-bound there too.
//
// What the design does about it.
//   - One block owns one tile of up to BR rows of one expert (BR = 8, 16,
//     32 or 64, picked by the wrapper from the mean rows an expert) and 64
//     output channels (16 a warp) of one of up to two weights that share x
//     (w_up and w_gate: one launch for both); a bf16 form's 64-row tile
//     (prefill) takes 128 channels (32 a warp, two m16 tiles that share
//     each B fragment) where every width allows, which halves the shared-
//     memory reads a product and the x rows' reloads across channel
//     groups. The grid is (the plan's static tile bound, channel groups): a
//     function of host shapes only, and a block whose tile is past the real
//     tile count returns at once.
//   - Each block streams its expert's [K, channels] slice through a ring of 32-
//     input stages in shared memory (cp.async, 4 deep; 3 for f32), with its
//     BR x rows gathered by token index into the same stage; the weight is
//     read once per tile, so at decode every distinct expert byte is read
//     once per channel group, which is what the bound counts.
//   - bf16 x: tensor cores (mma.m16n8k16) with the WEIGHT on the A side:
//     16 output channels by 16 inputs, and the rows on the n8 side, so a
//     decode tile of 1-8 rows fills one n8 tile and a 64-row prefill tile
//     eight. A bf16 weight's A fragments come from ldmatrix.trans of the
//     [k][channel] stage. An int8 weight is never widened in memory:
//     ldmatrix.trans of its bytes as 16-bit pairs gives a lane the int8
//     pairs (channel 2g, 2g + 1) x (input 2t, 2t + 1), which a byte permute
//     into the 2^23 magic float converts to bf16 exactly (int8_weight_gemm.cu
//     does the same); A's row g is then channel 2g and row g + 8 channel
//     2g + 1. The per-channel scale is applied once in the epilogue.
//   - f32 x: exact f32 products on the CUDA cores (FFMA), each thread a
//     (BR / 8) x 4 tile of rows by channels, a sequential sum over K; the
//     f32 path serves f32 engines and checks, not the served bf16 models.
//   - Every output is written by one thread after a sum in a fixed order,
//     with no atomics: a replayed graph equals an eager call bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 64;  // output channels a block at MT = 1 (16 a warp)
constexpr int kBK = 32;  // inputs a stage
constexpr int kMaxWeights = 2;

// up to two expert stacks of one launch (the same x and K): their bytes
// ([E, K, N] in x's type, or int8), int8 scales ([E, N] f32, or null),
// outputs ([rows, N] in x's type), widths and channel groups (of the launch's block width)
struct Weights {
  const void* w[kMaxWeights];
  const float* s[kMaxWeights];
  void* y[kMaxWeights];
  int N[kMaxWeights];
  int groups[kMaxWeights];
  int count;
};

// the shared-memory stage of one instantiation: BR rows of x (kBK inputs,
// padded by 16 bytes so that the eight rows an ldmatrix phase reads fall
// in different banks), then kBK rows of the weight's BN channels (padded
// likewise)
template <typename XT, typename WT, int BN>
struct Stage {
  static constexpr int kStages = std::is_same<XT, float>::value ? 3 : 4;
  static constexpr int kXRow = kBK * static_cast<int>(sizeof(XT)) + 16;
  static constexpr int kWRow = BN * static_cast<int>(sizeof(WT)) + 16;
  __host__ __device__ static constexpr int bytes(int br) { return br * kXRow + kBK * kWRow; }
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte idx of u (its bytes already XORed with 0x80, so q + 128) -> its
// int8 value as a float, exactly: the byte lands in the low byte of 2^23
__device__ __forceinline__ float i8_value(uint32_t u, int idx) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(f) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | idx));
  return __uint_as_float(f) - 8388736.0f;
}

// bytes lo and hi of a word of int8 weights -> bf16x2 {lo (low half), hi}
__device__ __forceinline__ uint32_t i8_pair_bf16x2(uint32_t word, int lo, int hi) {
  const uint32_t u = word ^ 0x80808080u;
  const __nv_bfloat162 v = __floats2bfloat162_rn(i8_value(u, lo), i8_value(u, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one stage: the tile's rows of x (gathered by token, rows past nrows
// zero-filled) and the weight slice [k0, k0 + kBK) x [n0, n0 + BN)
template <int BR, int BN, typename XT, typename WT>
__device__ __forceinline__ void load_stage(unsigned char* st, const XT* __restrict__ x,
                                           const int* rows_tok, int nrows, int K, int k0,
                                           const WT* __restrict__ wbase, int N) {
  using S = Stage<XT, WT, BN>;
  constexpr int kXPieces = kBK * sizeof(XT) / 16;
  for (int i = threadIdx.x; i < BR * kXPieces; i += kThreads) {
    const int r = i / kXPieces, p = i % kXPieces;
    const bool real = r < nrows;
    const XT* src = real ? x + static_cast<size_t>(rows_tok[r]) * K + k0
                               + p * static_cast<int>(16 / sizeof(XT))
                         : x;
    cp_async16(st + r * S::kXRow + p * 16, src, real ? 16 : 0);
  }
  constexpr int kWPieces = BN * sizeof(WT) / 16;
  unsigned char* ws = st + BR * S::kXRow;
  for (int i = threadIdx.x; i < kBK * kWPieces; i += kThreads) {
    const int r = i / kWPieces, p = i % kWPieces;
    const WT* src = wbase + static_cast<size_t>(k0 + r) * N + p * static_cast<int>(16 / sizeof(WT));
    cp_async16(ws + r * S::kWRow + p * 16, src, 16);
  }
}

// grid (tile bound, channel groups of all weights); block 128 threads.
// Tile b: expert tile_expert[b] (>= E: no tile, return), rows [tile_row[b],
// min(offsets[e + 1], tile_row[b] + BR)). XT: x's and y's type (bf16: the
// tensor-core form; float: FFMA); WT: the experts' type (XT or int8); MT:
// m16 channel tiles a warp (the bf16 forms; 1 for f32), 64 * MT channels a
// block.
template <int BR, int MT, typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
moe_expert_gemm_kernel(const XT* __restrict__ x, const int* __restrict__ tok, const Weights W,
                       const int* __restrict__ offsets, const int* __restrict__ tile_expert,
                       const int* __restrict__ tile_row, int E, int K) {
  constexpr int BN = kBN * MT;
  using S = Stage<XT, WT, BN>;
  constexpr bool kF32 = std::is_same<XT, float>::value;
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  static_assert(!kF32 || MT == 1, "the f32 form maps 64 channels to 16 threads");
  constexpr int kSB = S::bytes(BR);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows_tok[BR];

  const int e = tile_expert[blockIdx.x];
  if (e < 0 || e >= E) return;
  const int r0 = tile_row[blockIdx.x];
  const int nrows = min(offsets[e + 1], r0 + BR) - r0;
  // this block's weight and channel group (uniform), picked with constant
  // indices: a runtime index into the parameter struct would copy it to
  // local memory
  int grp = blockIdx.y;
  const void* wv = W.w[0];
  const float* s = W.s[0];
  void* y = W.y[0];
  int N = W.N[0];
  if (W.count > 1 && grp >= W.groups[0]) {
    grp -= W.groups[0];
    wv = W.w[1], s = W.s[1], y = W.y[1], N = W.N[1];
  }
  const int n0 = grp * BN;
  if (threadIdx.x < BR)
    rows_tok[threadIdx.x] =
        threadIdx.x < nrows ? (tok ? tok[r0 + threadIdx.x] : r0 + threadIdx.x) : 0;
  __syncthreads();
  const WT* wbase = static_cast<const WT*>(wv) + static_cast<size_t>(e) * K * N + n0;
  const int nk = K / kBK;

#pragma unroll
  for (int st = 0; st < S::kStages - 1; ++st) {
    if (st < nk)
      load_stage<BR, BN, XT, WT>(smem + st * kSB, x, rows_tok, nrows, K, st * kBK, wbase, N);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int NT = BR / 8;
  // [m16 tile][n8 tile] (f32: [row i][channel c] in acc[0])
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();
    const int nxt = kt + S::kStages - 1;
    if (nxt < nk)
      load_stage<BR, BN, XT, WT>(smem + (nxt % S::kStages) * kSB, x, rows_tok, nrows, K,
                                 nxt * kBK, wbase, N);
    cp_async_commit();
    const unsigned char* xs = smem + (kt % S::kStages) * kSB;
    const unsigned char* ws = xs + BR * S::kXRow;
    if constexpr (kF32) {
      // rows ty + 8i, channels tx + 16c: acc[i][c]
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float xv[NT], wf[4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
          xv[i] = *reinterpret_cast<const float*>(xs + (ty + 8 * i) * S::kXRow + kk * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kInt8) {
            wf[c] = static_cast<float>(
                *reinterpret_cast<const int8_t*>(ws + kk * S::kWRow + tx + 16 * c));
          } else {
            wf[c] = *reinterpret_cast<const float*>(ws + kk * S::kWRow + (tx + 16 * c) * 4);
          }
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[0][i][c] = fmaf(xv[i], wf[c], acc[0][i][c]);
      }
    } else {
      // A fragments of the stage's two k16 steps for each of this warp's
      // MT tiles of 16 channels (channels (warp * MT + mt) * 16 of the block)
      uint32_t a[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int c16 = warp * MT + mt;
        if constexpr (kInt8) {
          // matrix m = inputs 8m..8m+7 x the tile's 16 channel bytes; a
          // lane's word: (2t, ch 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1)
          uint32_t q[4];
          ldmatrix_x4_trans(q, ws + ((lane >> 3) * 8 + (lane & 7)) * S::kWRow + c16 * 16);
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            a[mt][st][0] = i8_pair_bf16x2(q[2 * st], 0, 2);
            a[mt][st][1] = i8_pair_bf16x2(q[2 * st], 1, 3);
            a[mt][st][2] = i8_pair_bf16x2(q[2 * st + 1], 0, 2);
            a[mt][st][3] = i8_pair_bf16x2(q[2 * st + 1], 1, 3);
          }
        } else {
          // matrices (inputs 0-7, ch 0-7), (0-7, 8-15), (8-15, 0-7), (8-15,
          // 8-15) of the step, transposed: a0..a3 of mma's A = W^T
          const int m = lane >> 3;
#pragma unroll
          for (int st = 0; st < 2; ++st)
            ldmatrix_x4_trans(a[mt][st], ws + (st * 16 + (lane & 7) + (m >> 1) * 8) * S::kWRow +
                                             (c16 * 16 + (m & 1) * 8) * 2);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // rows j*8..j*8+7 x inputs 0-7, 8-15, 16-23, 24-31: b0, b1 of step
        // 0, then of step 1, shared by the warp's MT tiles
        uint32_t b[4];
        ldmatrix_x4(b, xs + (j * 8 + (lane & 7)) * S::kXRow + (lane >> 3) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][j], a[mt][0], b[0], b[1]);
          mma_bf16(acc[mt][j], a[mt][1], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (kF32) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = n0 + tx + 16 * c;
      const float sc = kInt8 ? s[static_cast<size_t>(e) * N + ch] : 1.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int r = ty + 8 * i;
        if (r < nrows)
          static_cast<float*>(y)[static_cast<size_t>(r0 + r) * N + ch] = acc[0][i][c] * sc;
      }
    }
  } else {
    // acc[j]: (A row g, rows 2t, 2t + 1), (A row g + 8, rows 2t, 2t + 1);
    // A row g is channel g (bf16) or 2g (int8), row g + 8 channel g + 8 or
    // 2g + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = n0 + (warp * MT + mt) * 16 + (kInt8 ? 2 * g + h : g + 8 * h);
        const float sc = kInt8 ? s[static_cast<size_t>(e) * N + ch] : 1.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = j * 8 + 2 * t + u;
            if (r < nrows)
              static_cast<bf16*>(y)[static_cast<size_t>(r0 + r) * N + ch] =
                  __float2bfloat16_rn(acc[mt][j][2 * h + u] * sc);
          }
      }
  }
}

template <int BR, int MT, typename XT, typename WT>
cudaError_t launch(const XT* x, const int* tok, Weights W, const int* offsets,
                   const int* tile_expert, const int* tile_row, int n_tiles, int E, int K,
                   cudaStream_t stream) {
  auto kernel = moe_expert_gemm_kernel<BR, MT, XT, WT>;
  using S = Stage<XT, WT, kBN * MT>;
  const size_t smem = static_cast<size_t>(S::kStages) * S::bytes(BR);
  // once per instantiation: the attribute outlives the call
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  int groups = 0;
  for (int i = 0; i < W.count; ++i) groups += W.groups[i] = W.N[i] / (kBN * MT);
  kernel<<<dim3(n_tiles, groups, 1), dim3(kThreads, 1, 1), smem, stream>>>(
      x, tok, W, offsets, tile_expert, tile_row, E, K);
  return cudaGetLastError();
}

// the tile height's instantiation; a bf16 form's 64-row tile takes 128
// channels a block where every weight's width is a multiple of 128
template <typename XT, typename WT>
cudaError_t dispatch(int br, const XT* x, const int* tok, const Weights& W, const int* offsets,
                     const int* tile_expert, const int* tile_row, int n_tiles, int E, int K,
                     cudaStream_t st) {
  bool wide = !std::is_same<XT, float>::value;
  for (int i = 0; i < W.count; ++i) wide = wide && W.N[i] % (2 * kBN) == 0;
  switch (br) {
    case 8: return launch<8, 1, XT, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 16: return launch<16, 1, XT, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 32: return launch<32, 1, XT, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 64:
      if constexpr (!std::is_same<XT, float>::value) {
        if (wide)
          return launch<64, 2, XT, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
      }
      return launch<64, 1, XT, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y_i [rows, N_i] = x[tok] @ w_i[e] (* s_i[e] for int8 experts) for the
// count (1..2) expert stacks given, over the plan's tiles, in one launch.
// dtype: x's and y's type, 1 bf16 or 0 f32; wtype: the experts' type, 0
// x's or 1 int8 (then s_i [E, N_i] f32). tok: [rows] int32 row of x of
// each sorted assignment, or null (x's rows are the assignments). offsets
// [E + 1] int32, tile_expert / tile_row [n_tiles] int32 (ops/moe.py
// moe_plan). br in {8, 16, 32, 64}, K % 32 == 0, N_i % 64 == 0. Returns
// the CUDA error of the launch (0 = launched).
extern "C" int b2b_moe_expert_gemm(const void* x, const void* tok, int dtype, int wtype,
                                   int count, const void* w0, const void* s0, void* y0, int N0,
                                   const void* w1, const void* s1, void* y1, int N1,
                                   const void* offsets, const void* tile_expert,
                                   const void* tile_row, int n_tiles, int E, int K, int br,
                                   void* stream) {
  if (count < 1 || count > kMaxWeights || n_tiles < 1 || E < 1 || K < kBK || K % kBK != 0 ||
      (dtype != 0 && dtype != 1) || (wtype != 0 && wtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ws[kMaxWeights] = {w0, w1};
  const void* ss[kMaxWeights] = {s0, s1};
  void* ys[kMaxWeights] = {y0, y1};
  const int Ns[kMaxWeights] = {N0, N1};
  Weights W = {};
  W.count = count;
  for (int i = 0; i < count; ++i) {
    if (Ns[i] < kBN || Ns[i] % kBN != 0 || (wtype == 1 && ss[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    W.w[i] = ws[i];
    W.s[i] = static_cast<const float*>(ss[i]);
    W.y[i] = ys[i];
    W.N[i] = Ns[i];
  }
  const int* tk = static_cast<const int*>(tok);
  const int* off = static_cast<const int*>(offsets);
  const int* te = static_cast<const int*>(tile_expert);
  const int* tr = static_cast<const int*>(tile_row);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    err = wtype == 1 ? dispatch<bf16, int8_t>(br, xb, tk, W, off, te, tr, n_tiles, E, K, st)
                     : dispatch<bf16, bf16>(br, xb, tk, W, off, te, tr, n_tiles, E, K, st);
  } else {
    const float* xf = static_cast<const float*>(x);
    err = wtype == 1 ? dispatch<float, int8_t>(br, xf, tk, W, off, te, tr, n_tiles, E, K, st)
                     : dispatch<float, float>(br, xf, tk, W, off, te, tr, n_tiles, E, K, st);
  }
  return static_cast<int>(err);
}
