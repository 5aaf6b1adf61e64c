// The routed expert product of a mixture-of-experts layer: for every kept
// assignment a of a token to an expert, in the plan's sorted order (rows of
// one expert contiguous),
//   y[a, :] = x[tok[a], :] @ W[e(a)]            (x's type experts)
//   y[a, :] = (x[tok[a], :] @ q[e(a)]) * s[e(a)] (int8 experts, f32 scales
//                                                 per expert and channel)
// with W / q the JAX layout [E, K, N] (models/core.py: [E, in, out]), the
// sum in f32 and y in x's type: bf16 or f32, each output rounded once.
// ``tok`` may be null (the rows of x are the sorted assignments themselves:
// the down product over h).
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
// What bounds it. At decode and verify (a handful of rows an expert) the
// bytes of the distinct experts the step touches: qwen3-30b-a3b at B = 8
// reads about 52 of 128 experts, 0.49 GB a layer; mixtral-8x7b about 7.2
// of 8 int8 experts, 1.27 GB a layer (3.35 TB/s: 0.15 and 0.38 ms). At a
// prefill chunk the routed products: 2 * A * K * N for A assignments
// (mixtral at 2,048 tokens: 1.4 TFLOP a layer of gate, up and down, 1.5 ms
// at the bf16 peak of 989 TFLOP/s), while qwen3's experts stay byte-bound
// there too (1.2 GB of experts a layer, 0.36 ms). Between the two, what
// moves through L2: each weight slab and each x tile is read by many items,
// and the card's L2 cannot hold a whole chunk's worth of either.
//
// What the design does about it (bf16 x, bf16 or int8 experts: the served
// forms). One persistent block an SM walks work items: a tile of up to BR
// rows of one expert x 128 output channels of one of up to two weights
// that share x x one K split. Only the real tiles' items (the plan's tile
// count, read on the device), dealt round robin, so a decode step's few
// tiles spread evenly; expert-major (item_at), so the items in flight
// together share an expert's x tiles and read each weight slab once for
// all its tiles while both are in L2. A block is three warpgroups:
//   - a producer (setmaxnreg 40), of which one thread keeps a ring of
//     stages full in shared memory by TMA (cp.async.bulk.tensor over 2-D
//     tensor maps, 128-byte swizzle, completing on the stage's mbarrier):
//     64 inputs of the weight tile (a map of [E * K, N]) and the tile's
//     BR rows of x. Hopper's TMA cannot gather rows, and one 128-byte row
//     copy a row runs at a fraction of the rate, so a small first kernel
//     (moe_expert_gemm_kernel_gather) writes x's rows in the plan's sorted
//     order and the tile is one box of it; the down product's h is in that
//     order already. The ring is 4-16 stages deep (the most that fits): at
//     decode 72-204 KB of weights in flight an SM;
//   - two consumers (setmaxnreg 232), 64 output channels each, issue
//     wgmma.mma_async with the WEIGHT as A (M = channels) and the tile's
//     rows as B (N = rows, K-major, from shared memory): m64nBRk16, so one
//     instruction covers a prefill tile of 256 rows and a decode tile of 8
//     a single n8 product. A bf16 weight is A from shared memory through a
//     descriptor, MN-major (channel-contiguous, as it lies in [E, K, N]);
//     an int8 weight is never widened in memory: ldmatrix.trans of its
//     bytes as 16-bit pairs gives a lane the pairs (channel 2g, 2g + 1) x
//     (input 2t, 2t + 1), which a byte permute into the 2^23 magic float
//     and a permute of the high halves convert to bf16 exactly (|q| <= 128
//     has 8 significant bits): the A fragments of wgmma's register form,
//     A's row g then channel 2g and row g + 8 channel 2g + 1, the scale
//     applied once in the epilogue. A partial last tile of an expert (rows
//     <= BR / 2, <= BR / 4 at BR >= 128) runs the narrower product.
//     Outputs go through a shared-memory staging buffer and out in 16-byte
//     pieces along y's rows with an evict-first hint: scattered 2-byte
//     stores, and outputs that pushed the shared tiles out of L2, were the
//     largest cost of a prefill chunk (moe_probe.py --kernel times it).
//   - Prefill tiles are 128 or 256 rows (ops/moe.py tile_rows: about one
//     tile an expert at a 2,048-token chunk), so each expert's weight slice
//     is streamed once or twice per channel group.
//   - Where a decode-height tile's grid is short against a deep K
//     (mixtral's w_down: K = 14,336 over about 8 tiles x 32 channel groups)
//     the plan splits K (ops/moe.py k_splits, a function of host shapes):
//     each split writes its f32 partial sums, and a second kernel
//     (moe_expert_gemm_kernel_reduce) sums them in split order, scales and
//     rounds once. No atomics anywhere: a replayed graph equals an eager
//     call bit for bit.
// f32 x (f32 engines and checks, not the served bf16 models): exact f32
// products on the CUDA cores (FFMA), one block a tile of BR <= 64 rows x 64
// channels, each thread a (BR / 8) x 4 tile of rows by channels, a
// sequential sum over K, fed by a cp.async ring of 32-input stages.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWeights = 2;

// what moe_probe.py --kernel builds besides the kernel, to time its parts
// apart (wrong results): 1 no x tiles copied, 2 no products, 3 int8 bytes
// taken as A fragments unconverted, 4 every item reading expert 0's weight
// slabs (warm in L2), 5 no outputs stored. 0 (the port's build): none
#ifndef MOE_PROBE_PART
#define MOE_PROBE_PART 0
#endif
constexpr int kProbePart = MOE_PROBE_PART;

// up to two expert stacks of one launch (the same x and K): their bytes
// ([E, K, N] in x's type, or int8), int8 scales ([E, N] f32, or null),
// outputs ([rows, N] in x's type), f32 partial sums of a K split ([splits,
// rows, N], or null), widths and channel groups (of the form's block width)
struct Weights {
  const void* w[kMaxWeights];
  const float* s[kMaxWeights];
  void* y[kMaxWeights];
  float* part[kMaxWeights];
  int N[kMaxWeights];
  int groups[kMaxWeights];
  int count;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory, asynchronous; with src_bytes
// 0 nothing is read and the slot is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// ------------------------------------------------------------ f32 x: FFMA

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 64;  // output channels a block (16 threads x 4)
constexpr int kBK = 32;  // inputs a stage
constexpr int kStagesF32 = 3;

// the shared-memory stage of one instantiation: BR rows of x (kBK inputs,
// padded by 16 bytes), then kBK rows of the weight's kBN channels (padded
// likewise)
template <typename WT>
struct Stage {
  static constexpr int kXRow = kBK * 4 + 16;
  static constexpr int kWRow = kBN * static_cast<int>(sizeof(WT)) + 16;
  __host__ __device__ static constexpr int bytes(int br) { return br * kXRow + kBK * kWRow; }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one stage: the tile's rows of x (gathered by token, rows past nrows
// zero-filled) and the weight slice [k0, k0 + kBK) x [n0, n0 + kBN)
template <int BR, typename WT>
__device__ __forceinline__ void load_stage(unsigned char* st, const float* __restrict__ x,
                                           const int* rows_tok, int nrows, int K, int k0,
                                           const WT* __restrict__ wbase, int N) {
  using S = Stage<WT>;
  constexpr int kXPieces = kBK * 4 / 16;
  for (int i = threadIdx.x; i < BR * kXPieces; i += kThreads) {
    const int r = i / kXPieces, p = i % kXPieces;
    const bool real = r < nrows;
    const float* src = real ? x + static_cast<size_t>(rows_tok[r]) * K + k0 + p * 4 : x;
    cp_async16(smem_u32(st + r * S::kXRow + p * 16), src, real ? 16 : 0);
  }
  constexpr int kWPieces = kBN * sizeof(WT) / 16;
  unsigned char* ws = st + BR * S::kXRow;
  for (int i = threadIdx.x; i < kBK * kWPieces; i += kThreads) {
    const int r = i / kWPieces, p = i % kWPieces;
    const WT* src = wbase + static_cast<size_t>(k0 + r) * N + p * static_cast<int>(16 / sizeof(WT));
    cp_async16(smem_u32(ws + r * S::kWRow + p * 16), src, 16);
  }
}

// grid (tile bound, channel groups of all weights); block 128 threads.
// Tile b: expert tile_expert[b] (>= E: no tile, return), rows [tile_row[b],
// min(offsets[e + 1], tile_row[b] + BR)). XT: x's and y's type (float);
// WT: the experts' type (float or int8).
template <int BR, typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
moe_expert_gemm_kernel(const XT* __restrict__ x, const int* __restrict__ tok, const Weights W,
                       const int* __restrict__ offsets, const int* __restrict__ tile_expert,
                       const int* __restrict__ tile_row, int E, int K) {
  using S = Stage<WT>;
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  static_assert(std::is_same<XT, float>::value, "the FFMA form is f32 x's");
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
  const int n0 = grp * kBN;
  if (threadIdx.x < BR)
    rows_tok[threadIdx.x] =
        threadIdx.x < nrows ? (tok ? tok[r0 + threadIdx.x] : r0 + threadIdx.x) : 0;
  __syncthreads();
  const WT* wbase = static_cast<const WT*>(wv) + static_cast<size_t>(e) * K * N + n0;
  const int nk = K / kBK;

#pragma unroll
  for (int st = 0; st < kStagesF32 - 1; ++st) {
    if (st < nk) load_stage<BR, WT>(smem + st * kSB, x, rows_tok, nrows, K, st * kBK, wbase, N);
    cp_async_commit();
  }

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int NT = BR / 8;
  // rows ty + 8i, channels tx + 16c: acc[i][c]
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStagesF32 - 2>();
    __syncthreads();
    const int nxt = kt + kStagesF32 - 1;
    if (nxt < nk)
      load_stage<BR, WT>(smem + (nxt % kStagesF32) * kSB, x, rows_tok, nrows, K, nxt * kBK,
                         wbase, N);
    cp_async_commit();
    const unsigned char* xs = smem + (kt % kStagesF32) * kSB;
    const unsigned char* ws = xs + BR * S::kXRow;
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
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[i], wf[c], acc[i][c]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int ch = n0 + tx + 16 * c;
    const float sc = kInt8 ? s[static_cast<size_t>(e) * N + ch] : 1.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int r = ty + 8 * i;
      if (r < nrows) static_cast<float*>(y)[static_cast<size_t>(r0 + r) * N + ch] = acc[i][c] * sc;
    }
  }
}

template <int BR, typename WT>
cudaError_t launch_f32(const float* x, const int* tok, Weights W, const int* offsets,
                       const int* tile_expert, const int* tile_row, int n_tiles, int E, int K,
                       cudaStream_t stream) {
  auto kernel = moe_expert_gemm_kernel<BR, float, WT>;
  const size_t smem = static_cast<size_t>(kStagesF32) * Stage<WT>::bytes(BR);
  // once per instantiation: the attribute outlives the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  int groups = 0;
  for (int i = 0; i < W.count; ++i) groups += W.groups[i] = W.N[i] / kBN;
  kernel<<<dim3(n_tiles, groups, 1), dim3(kThreads, 1, 1), smem, stream>>>(
      x, tok, W, offsets, tile_expert, tile_row, E, K);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch_f32(int br, const float* x, const int* tok, const Weights& W,
                         const int* offsets, const int* tile_expert, const int* tile_row,
                         int n_tiles, int E, int K, cudaStream_t st) {
  switch (br) {
    case 8: return launch_f32<8, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 16: return launch_f32<16, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 32: return launch_f32<32, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    case 64: return launch_f32<64, WT>(x, tok, W, offsets, tile_expert, tile_row, n_tiles, E, K, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ bf16 x: wgmma

constexpr int kWgThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kWgChannels = 128;  // output channels an item, 64 a consumer warpgroup
constexpr int kSlab = 64;  // inputs a stage: one 128-byte swizzle row of bf16 x
constexpr int kMaxStages = 16;
constexpr int kSmemBudget = 220 * 1024;

// a stage: the weight tile [kSlab inputs][128 channels] as TMA lays it
// (bf16: two 64-channel boxes, one a consumer warpgroup; int8: one box),
// then BR rows of x [row][kSlab inputs]: every piece a multiple of 1,024
// bytes, each 128-byte row's 16-byte chunk c at c ^ (row % 8)
template <int BR, typename WT>
struct WgStage {
  static constexpr int kWBytes = kSlab * kWgChannels * static_cast<int>(sizeof(WT));
  static constexpr int kBoxBytes = kSlab * 64 * 2;  // a bf16 box of 64 channels
  static constexpr int kXBytes = BR * kSlab * 2;
  static constexpr int kBytes = kWBytes + kXBytes;
  // a consumer warpgroup's output staging: up to 64 rows x 64 channels bf16
  static constexpr int kStagingBytes = (BR < 64 ? BR : 64) * 128;
  static constexpr int kRing = kSmemBudget - 2 * kStagingBytes;
  static constexpr int kStages = kRing / kBytes < kMaxStages ? kRing / kBytes : kMaxStages;
  // + the 1,024-byte alignment
  static constexpr int kSmem = kStages * kBytes + 2 * kStagingBytes + 1024;
};

constexpr int kFullArrivals = 1;  // the TMA issuer's expect_tx
constexpr int kMaxSplitRows = 32;  // the tallest tile a K split takes (ops/moe.py k_splits)
// lane 0 of each consumer warp, once its warpgroup's products that read the
// stage are done
constexpr int kEmptyArrivals = 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1,024
// bytes apart (the stride byte offset); the leading offset is unused for
// these layouts (K-major swizzled; MN-major one swizzle atom wide)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
struct Tag {};

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16: A from shared memory
// (MN-major: imm-trans-a 1) or from registers, B from shared memory
// (K-major); acc 0 overwrites d. Every output register is an operand.
__device__ __forceinline__ void wgmma_ss(Tag<8>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(Tag<16>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(Tag<32>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(Tag<64>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(Tag<128>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(Tag<256>, float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<8>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<16>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<32>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<64>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<128>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(Tag<256>, float* d, const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// byte idx of u (its bytes already XORed with 0x80, so q + 128) -> its
// int8 value as a float, exactly: the byte lands in the low byte of 2^23
__device__ __forceinline__ uint32_t i8_value(uint32_t u, int idx) {
  uint32_t f;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(f) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | idx));
  return __float_as_uint(__uint_as_float(f) - 8388736.0f);
}

// bytes lo and hi of a word of int8 weights -> bf16x2 {lo (low half), hi}:
// the high halves of the exact floats (an integer of 8 significant bits is
// a bf16 as it stands)
__device__ __forceinline__ uint32_t i8_pair_bf16x2(uint32_t word, int lo, int hi) {
  const uint32_t u = word ^ 0x80808080u;
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x7632;\n" : "=r"(r) : "r"(i8_value(u, lo)), "r"(i8_value(u, hi)));
  return r;
}

// the A fragments of a stage's int8 tile ([64 inputs][128 channel bytes],
// swizzled) for this warp's 16 channels (16-byte chunk c16 of each row):
// a[ks] for the k16 steps ks = 0..3. Matrix m of an ldmatrix.x4.trans is
// inputs 8m..8m+7 x the 16 channel bytes as 8 16-bit pairs; a lane's word:
// (2t, ch 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1)
__device__ __forceinline__ void int8_frags(uint32_t (&a)[4][4], uint32_t tile, int c16,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 32 * h + (lane >> 3) * 8 + (lane & 7);
    uint32_t q[4];
    ldmatrix_x4_trans(q, tile + i * 128 + ((c16 ^ (lane & 7)) << 4));
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      if constexpr (kProbePart == 3) {
        a[2 * h + st][0] = a[2 * h + st][1] = q[2 * st];
        a[2 * h + st][2] = a[2 * h + st][3] = q[2 * st + 1];
        continue;
      }
      a[2 * h + st][0] = i8_pair_bf16x2(q[2 * st], 0, 2);
      a[2 * h + st][1] = i8_pair_bf16x2(q[2 * st], 1, 3);
      a[2 * h + st][2] = i8_pair_bf16x2(q[2 * st + 1], 0, 2);
      a[2 * h + st][3] = i8_pair_bf16x2(q[2 * st + 1], 1, 3);
    }
  }
}

// the registers of an in-flight wgmma's A fragments stay theirs up to here
__device__ __forceinline__ void keep_alive(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    asm volatile("" ::"r"(a[ks][0]), "r"(a[ks][1]), "r"(a[ks][2]), "r"(a[ks][3]));
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, float v) {
  const bf16 b = __float2bfloat16_rn(v);
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(*reinterpret_cast<const uint16_t*>(&b))
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// a 16-byte store that L2 evicts first: the outputs are not read again
// here, and the weight and x tiles the other items share stay in L2
__device__ __forceinline__ void st_global_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// the ring's position: its stage and the parity of the stage's phase
struct Ring {
  int stage;
  uint32_t phase;
  template <int kStages>
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
};

// a work item: a tile (expert e, rows [r0, r0 + nrows)), a weight wi and
// its 128 channels from n0, a K split
struct Item {
  int e, r0, nrows, wi, n0, split;
};

// item -> (split, expert, channel group, tile), expert-major: within a
// split, expert e's items are [first(e) * groups, (first(e) + count(e)) *
// groups) over its count(e) tiles from slot first(e), group-major, tile
// fastest. The items that run together then share the x tiles of an
// expert or two and read each weight slab once for all its tiles, which
// keeps both in L2
__device__ __forceinline__ Item item_at(int item, int n_tiles, int groups, const Weights& W,
                                        const int* offsets, const int* tile_expert,
                                        const int* tile_row, int br) {
  const int per_split = n_tiles * groups, w = item % per_split;
  const int b = w / groups;  // a tile of the item's expert
  Item it;
  it.split = item / per_split;
  it.e = tile_expert[b];
  const int first_row = offsets[it.e];
  const int count = (offsets[it.e + 1] - first_row + br - 1) / br;
  const int first = b - (tile_row[b] - first_row) / br;
  const int local = w - first * groups, g = local / count;
  it.r0 = first_row + (local % count) * br;
  it.nrows = min(offsets[it.e + 1], it.r0 + br) - it.r0;
  it.wi = W.count > 1 && g >= W.groups[0];
  it.n0 = (it.wi ? g - W.groups[0] : g) * kWgChannels;
  return it;
}

// one item's products on the consumer side, rows as NS-wide wgmma (NS >=
// the item's rows), then its epilogue: y (or the split's f32 partial sums)
// for this warpgroup's 64 channels
template <int NS, int BR, typename WT>
__device__ __forceinline__ void consume(float* acc, Ring& ring, int nk, uint32_t base,
                                        uint32_t full, uint32_t empty, uint32_t stage,
                                        const Item& it, const Weights& W, int E, int rows,
                                        int cw, int warp, int lane) {
  using S = WgStage<BR, WT>;
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  int prev = 0;
  // one stage's products into acc; int8: with a the A fragments, written
  // here, and a_prev those of the previous stage's products, which may
  // still be reading their registers until the wait below retires them:
  // named after it, they keep their registers, so a is not given them
  auto step = [&](int kt, uint32_t (&a)[4][4], const uint32_t (&a_prev)[4][4]) {
    mbar_wait(full + 8 * ring.stage, ring.phase);
    const uint32_t st = base + ring.stage * S::kBytes, xs = st + S::kWBytes;
    if constexpr (kProbePart == 2) {
      wgmma_fence();
    } else if constexpr (kInt8) {
      int8_frags(a, st, cw * 4 + warp, lane);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs(Tag<NS>(), acc, a[ks], sw128_desc(xs + 32 * ks), kt | ks);
    } else {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss(Tag<NS>(), acc, sw128_desc(st + cw * S::kBoxBytes + 2048 * ks),
                 sw128_desc(xs + 32 * ks), kt | ks);
    }
    wgmma_commit();
    // the previous stage's products are done: its buffers go back
    wgmma_wait<1>();
    if constexpr (kInt8) keep_alive(a_prev);
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = ring.stage;
    ring.template advance<S::kStages>();
  };
  uint32_t a0[4][4] = {}, a1[4][4] = {};
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, a0, a1);
    if (kt + 1 < nk) step(kt + 1, a1, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  if (lane == 0) mbar_arrive(empty + 8 * prev);
  if constexpr (kProbePart == 5) return;

  // acc[4j + 2h + u]: A row g + 8h of the warp's 16, tile row 8j + 2t + u;
  // A row g + 8h is channel g + 8h (bf16) or 2g + h (int8) of the 16
  const int g = lane >> 2, t = lane & 3;
  const int N = it.wi ? W.N[1] : W.N[0];
  const int chw = it.n0 + cw * 64 + warp * 16;
  bf16* y = static_cast<bf16*>(it.wi ? W.y[1] : W.y[0]);
  float* part = it.wi ? W.part[1] : W.part[0];
  // a K split (decode-height tiles only): f32 partial sums, unscaled,
  // straight out
  if (BR <= kMaxSplitRows && part) {
    part += (static_cast<size_t>(it.split) * rows + it.r0) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = chw + (kInt8 ? 2 * g + h : g + 8 * h);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = 8 * j + 2 * t + u;
          if (r < it.nrows && ch < N) part[static_cast<size_t>(r) * N + ch] = acc[4 * j + 2 * h + u];
        }
    }
    return;
  }
  // y through this warpgroup's staging buffer, 64 rows at a time: each
  // thread puts its outputs, rounded, at [row][channel] (16-byte chunk q
  // of a row at q ^ (row % 8), so the threads of a store hit distinct
  // banks), then the warpgroup copies the tile's rows out in 16-byte
  // pieces along the rows of y
  constexpr int kRows = NS < 64 ? NS : 64;
  const int bar_id = 1 + cw, ct = warp * 32 + lane;
  float s0 = 1.f, s1 = 1.f;
  if constexpr (kInt8) {
    const int ch = min(chw + 2 * g, N - 2);  // past N: read in bounds, never stored
    const float* sp = (it.wi ? W.s[1] : W.s[0]) + static_cast<size_t>(it.e) * N + ch;
    s0 = sp[0], s1 = sp[1];
  }
#pragma unroll
  for (int c = 0; c < NS / kRows; ++c) {
    if (c * kRows >= it.nrows) break;
    named_barrier(bar_id);  // the buffer's last rows are out
#pragma unroll
    for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = c * (kRows / 8) + jj, r = 8 * jj + 2 * t + u;
        const uint32_t row = stage + r * 128;
        if constexpr (kInt8) {  // channels 2g, 2g + 1 of the warp's 16
          const int q = warp * 2 + (g >> 2);
          st_shared_b32(row + ((q ^ (r & 7)) << 4) + (g & 3) * 4,
                        bf16x2_bits(acc[4 * j + u] * s0, acc[4 * j + 2 + u] * s1));
        } else {  // channels g, g + 8 of the warp's 16
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = warp * 2 + h;
            st_shared_b16(row + ((q ^ (r & 7)) << 4) + g * 2, acc[4 * j + 2 * h + u]);
          }
        }
      }
    named_barrier(bar_id);  // the rows are in
    const int rows_out = min(kRows, it.nrows - c * kRows);
    bf16* out = y + static_cast<size_t>(it.r0 + c * kRows) * N + it.n0 + cw * 64;
    for (int i = ct; i < rows_out * 8; i += 128) {
      const int r = i >> 3, q = i & 7;
      if (it.n0 + cw * 64 + q * 8 < N)
        st_global_stream(out + static_cast<size_t>(r) * N + q * 8,
                         ld_shared_v4(stage + r * 128 + ((q ^ (r & 7)) << 4)));
    }
  }
}

// one persistent block an SM (grid: min(SMs, the items' bound)); block
// 384 threads: warpgroup 0 the producer, 1 and 2 the consumers of
// channels 0-63 and 64-127 of each item. Items: the real tiles (*tile_count
// of the plan's slots, which come first) x the channel groups of all
// weights x the K splits, in item_at's order. BR: the tile height (wgmma's
// N); WT: the experts' type (bf16: A from shared memory; int8: from
// registers).
template <int BR, typename WT>
__global__ void __launch_bounds__(kWgThreads, 1)
moe_expert_gemm_kernel_wgmma(const __grid_constant__ CUtensorMap map0,
                             const __grid_constant__ CUtensorMap map1,
                             const __grid_constant__ CUtensorMap xmap,
                             const Weights W, const int* __restrict__ offsets,
                             const int* __restrict__ tile_expert,
                             const int* __restrict__ tile_row, const int* __restrict__ tile_count,
                             int E, int K, int rows, int splits) {
  using S = WgStage<BR, WT>;
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S::kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * S::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(full + 8 * i, kFullArrivals);
      mbar_init(empty + 8 * i, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = *tile_count;
  const int groups = W.groups[0] + (W.count > 1 ? W.groups[1] : 0);
  const int n_items = n_tiles * groups * splits;
  const int nk = K / kSlab / splits;  // stages an item
  Ring ring{0, 0};

  // the warpgroup, made warp-uniform for the compiler: each role is a
  // region of its own, under its own register budget
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {
    // the producer: one thread issues a stage's TMA copies, the weight
    // tile and the tile's BR rows of x (in the plan's sorted order: rows
    // past the tile's own, or past x's end, only feed outputs that are not
    // written), and the bytes the stage's barrier expects
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = item_at(item, n_tiles, groups, W, offsets, tile_expert, tile_row, BR);
        const int N = it.wi ? W.N[1] : W.N[0];
        const CUtensorMap* map = it.wi ? &map1 : &map0;
        const int k0 = it.split * nk * kSlab;
        // a bf16 weight's second box only where the width reaches it
        const bool second = !kInt8 && it.n0 + 64 < N;
        const int bytes = (kInt8 ? S::kWBytes : (second ? 2 : 1) * S::kBoxBytes) +
                          (kProbePart == 1 ? 0 : S::kXBytes);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t st = base + ring.stage * S::kBytes, bar = full + 8 * ring.stage;
          const int k = k0 + kt * kSlab;
          const int wrow = (kProbePart == 4 ? 0 : it.e) * K + k;
          mbar_expect_tx(bar, bytes);
          tma_load_2d(st, map, it.n0, wrow, bar);
          if (second) tma_load_2d(st + S::kBoxBytes, map, it.n0 + 64, wrow, bar);
          if (kProbePart != 1) tma_load_2d(st + S::kWBytes, &xmap, k, it.r0, bar);
          ring.template advance<S::kStages>();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    const uint32_t staging = base + S::kStages * S::kBytes + cw * S::kStagingBytes;
    float acc[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item it = item_at(item, n_tiles, groups, W, offsets, tile_expert, tile_row, BR);
      // a partial tile runs the narrowest product that holds its rows
      if constexpr (BR >= 128) {
        if (it.nrows <= BR / 4) {
          consume<BR / 4, BR, WT>(acc, ring, nk, base, full, empty, staging, it, W, E, rows, cw,
                                  warp, lane);
          continue;
        }
        if (it.nrows <= BR / 2) {
          consume<BR / 2, BR, WT>(acc, ring, nk, base, full, empty, staging, it, W, E, rows, cw,
                                  warp, lane);
          continue;
        }
      }
      consume<BR, BR, WT>(acc, ring, nk, base, full, empty, staging, it, W, E, rows, cw,
                                  warp, lane);
    }
  }
}

// a K split's second pass: each kept row's output = its f32 partial sums
// over the splits in split order, times the int8 scale, rounded once.
// grid (tile bound, channel groups of all weights), block 128 channels
template <typename WT>
__global__ void __launch_bounds__(kWgChannels)
moe_expert_gemm_kernel_reduce(const Weights W, const int* __restrict__ offsets,
                              const int* __restrict__ tile_expert,
                              const int* __restrict__ tile_row, int E, int br, int rows,
                              int splits) {
  const int e = tile_expert[blockIdx.x];
  if (e < 0 || e >= E) return;
  const int r0 = tile_row[blockIdx.x];
  const int nrows = min(offsets[e + 1], r0 + br) - r0;
  const bool w1 = W.count > 1 && static_cast<int>(blockIdx.y) >= W.groups[0];
  const int N = w1 ? W.N[1] : W.N[0];
  const int ch = (w1 ? blockIdx.y - W.groups[0] : blockIdx.y) * kWgChannels + threadIdx.x;
  if (ch >= N) return;
  const float* part = w1 ? W.part[1] : W.part[0];
  bf16* y = static_cast<bf16*>(w1 ? W.y[1] : W.y[0]);
  const float sc =
      std::is_same<WT, int8_t>::value ? (w1 ? W.s[1] : W.s[0])[static_cast<size_t>(e) * N + ch]
                                      : 1.f;
  for (int r = r0; r < r0 + nrows; ++r) {
    float sum = 0.f;
    for (int k = 0; k < splits; ++k) sum += part[(static_cast<size_t>(k) * rows + r) * N + ch];
    y[static_cast<size_t>(r) * N + ch] = __float2bfloat16_rn(sum * sc);
  }
}

// x's rows in the plan's sorted order, xs[r] = x[tok[r]] for the kept rows
// r < offsets[E]: what the wgmma form's x tiles are cut from (TMA has no
// gather). grid (rows), block 128
__global__ void __launch_bounds__(128)
moe_expert_gemm_kernel_gather(const bf16* __restrict__ x, const int* __restrict__ tok,
                              bf16* __restrict__ xs, const int* __restrict__ offsets, int E,
                              int K) {
  const int r = blockIdx.x;
  if (r >= offsets[E]) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(tok[r]) * K);
  uint4* dst = reinterpret_cast<uint4*>(xs + static_cast<size_t>(r) * K);
  for (int i = threadIdx.x; i < K / 8; i += 128) dst[i] = src[i];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda);
// null where this driver or runtime does not carry it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a TMA map of a row-major [outer, inner] array of bf16 or bytes, boxes
// of box_outer rows x box_inner elements, 128-byte swizzle: an expert
// stack [E, K, N] as [E * K, N] in boxes of 64 inputs x 128 int8 or 64
// bf16 channels; the sorted rows of x [rows, K] in boxes of BR rows x 64
// inputs
cudaError_t tile_map(CUtensorMap* map, const void* p, bool bytes, uint64_t outer,
                     uint64_t inner, uint32_t box_outer, uint32_t box_inner) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * (bytes ? 1 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BR, typename WT>
cudaError_t launch_wgmma(const bf16* x, const int* tok, bf16* xs, Weights W,
                         const int* offsets, const int* tile_expert, const int* tile_row,
                         const int* tile_count, int n_tiles, int rows, int E, int K, int splits,
                         cudaStream_t stream) {
  using S = WgStage<BR, WT>;
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  auto kernel = moe_expert_gemm_kernel_wgmma<BR, WT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[kMaxWeights] = {}, xmap;
  cudaError_t err = tile_map(&xmap, tok ? xs : x, false, rows, K, BR, kSlab);
  int groups = 0;
  for (int i = 0; i < W.count && err == cudaSuccess; ++i) {
    err = tile_map(&maps[i], W.w[i], kInt8, static_cast<uint64_t>(E) * K, W.N[i], kSlab,
                   kInt8 ? 128 : 64);
    groups += W.groups[i] = (W.N[i] + kWgChannels - 1) / kWgChannels;
  }
  if (err != cudaSuccess) return err;
  if (tok) {
    moe_expert_gemm_kernel_gather<<<rows, 128, 0, stream>>>(x, tok, xs, offsets, E, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = min(sms, n_tiles * groups * splits);
  kernel<<<grid, kWgThreads, S::kSmem, stream>>>(maps[0], maps[1], xmap, W, offsets,
                                                 tile_expert, tile_row, tile_count, E, K, rows,
                                                 splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  moe_expert_gemm_kernel_reduce<WT><<<dim3(n_tiles, groups, 1), kWgChannels, 0, stream>>>(
      W, offsets, tile_expert, tile_row, E, BR, rows, splits);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch_wgmma(int br, const bf16* x, const int* tok, bf16* xs, const Weights& W,
                           const int* offsets, const int* te, const int* tr, const int* tc,
                           int n_tiles, int rows, int E, int K, int splits, cudaStream_t st) {
#define MOE_LAUNCH(BR) \
  launch_wgmma<BR, WT>(x, tok, xs, W, offsets, te, tr, tc, n_tiles, rows, E, K, splits, st)
  switch (br) {
    case 8: return MOE_LAUNCH(8);
    case 16: return MOE_LAUNCH(16);
    case 32: return MOE_LAUNCH(32);
    case 64: return MOE_LAUNCH(64);
    case 128: return MOE_LAUNCH(128);
    case 256: return MOE_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef MOE_LAUNCH
}

}  // namespace

// y_i [rows, N_i] = x[tok] @ w_i[e] (* s_i[e] for int8 experts) for the
// count (1..2) expert stacks given, over the plan's tiles, from one call.
// dtype: x's and y's type, 1 bf16 (the wgmma form) or 0 f32 (FFMA); wtype:
// the experts' type, 0 x's or 1 int8 (then s_i [E, N_i] f32). tok: [rows]
// int32 row of x of each sorted assignment, or null (x's rows are the
// assignments). offsets [E + 1] int32, tile_expert / tile_row [n_tiles]
// int32, tile_count [1] int32 the real tiles (ops/moe.py moe_plan); rows:
// the plan's sorted rows; xs: with tok, a bf16 scratch [rows, K] for x's
// rows in sorted order (the wgmma form). br:
// 8..256 (bf16), 8..64 (f32). N_i % 64 == 0; K % 64 == 0 (bf16), K % 32 ==
// 0 (f32). splits: K splits (bf16 only; (K / 64) % splits == 0), each p_i
// then an f32 scratch [splits, rows, N_i]. Returns the CUDA error of the
// launches (0 = launched).
extern "C" int b2b_moe_expert_gemm(const void* x, const void* tok, int dtype, int wtype,
                                   int count, const void* w0, const void* s0, void* y0,
                                   void* p0, int N0, const void* w1, const void* s1, void* y1,
                                   void* p1, int N1, const void* offsets,
                                   const void* tile_expert, const void* tile_row,
                                   const void* tile_count, void* xs, int n_tiles, int rows,
                                   int E, int K, int br, int splits, void* stream) {
  if (count < 1 || count > kMaxWeights || n_tiles < 1 || E < 1 || splits < 1 ||
      (dtype != 0 && dtype != 1) || (wtype != 0 && wtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16x = dtype == 1;
  const int kstep = bf16x ? kSlab : kBK;
  if (K < kstep || K % kstep != 0 || (K / kstep) % splits != 0 || (!bf16x && splits != 1) ||
      (bf16x && (tile_count == nullptr || (tok != nullptr && xs == nullptr))) ||
      (splits > 1 && br > kMaxSplitRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ws[kMaxWeights] = {w0, w1};
  const void* ss[kMaxWeights] = {s0, s1};
  void* ys[kMaxWeights] = {y0, y1};
  void* ps[kMaxWeights] = {p0, p1};
  const int Ns[kMaxWeights] = {N0, N1};
  Weights W = {};
  W.count = count;
  for (int i = 0; i < count; ++i) {
    if (Ns[i] < kBN || Ns[i] % kBN != 0 || (wtype == 1 && ss[i] == nullptr) ||
        (splits > 1 && ps[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    W.w[i] = ws[i];
    W.s[i] = static_cast<const float*>(ss[i]);
    W.y[i] = ys[i];
    W.part[i] = splits > 1 ? static_cast<float*>(ps[i]) : nullptr;
    W.N[i] = Ns[i];
  }
  const int* tk = static_cast<const int*>(tok);
  const int* off = static_cast<const int*>(offsets);
  const int* te = static_cast<const int*>(tile_expert);
  const int* tr = static_cast<const int*>(tile_row);
  const int* tc = static_cast<const int*>(tile_count);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16x) {
    const bf16* xb = static_cast<const bf16*>(x);
    err = wtype == 1
              ? dispatch_wgmma<int8_t>(br, xb, tk, static_cast<bf16*>(xs), W, off, te, tr, tc,
                                       n_tiles, rows, E, K, splits, st)
              : dispatch_wgmma<bf16>(br, xb, tk, static_cast<bf16*>(xs), W, off, te, tr, tc,
                                     n_tiles, rows, E, K, splits, st);
  } else {
    const float* xf = static_cast<const float*>(x);
    err = wtype == 1 ? dispatch_f32<int8_t>(br, xf, tk, W, off, te, tr, n_tiles, E, K, st)
                     : dispatch_f32<float>(br, xf, tk, W, off, te, tr, n_tiles, E, K, st);
  }
  return static_cast<int>(err);
}
