// The int8-weight GEMM of the serving forward: y[M, N] = (x[M, K] @ q[K, N])
// * s[N], q int8 (weight-only quantized, models/quant.py) in the JAX layout
// [K, N], s f32 per output channel, the sum in f32 and each output rounded
// once, after the scale; x and y in the activations' type: bf16, or f32
// (the f32 form, below). Up to three weights that share x (wq|wk|wv,
// w_up|w_gate) are one launch, so a layer takes 4.
//
// What it replaces. No TPU kernel: the JAX package's core.matmul computes
// (x @ q.astype(x.dtype)) * s and XLA fuses the int8 -> bf16 convert into
// the dot's operand read, so the weights leave HBM as int8. The same line in
// PyTorch writes a bf16 copy of every weight on every call and reads it
// back. This kernel reads each int8 weight byte once per row tile and writes
// no copy, at every token count: no dequantize scratch for bf16.
//
// What bounds it. At decode and verify (M <= 64, kernel A) the bytes: K*N
// int8 + 4N scale bytes + the activations, over 3.35 TB/s (llama-3-8b w_up
// at M = 8: 58.8 MB, 17.6 us); at a prefill chunk (kernel B) the products,
// 2MKN at the bf16 peak of 989 TFLOP/s (w_up at M = 2,048: 0.243 ms).
//
// What the design does about it. One persistent block an SM walks work
// items: a row tile of BR tokens x 128 output channels of one weight x one
// K split. Items are tile-fastest, so the blocks in flight together read
// each weight slab once for all its row tiles while it is in L2. A block is
// three warpgroups:
//   - a producer (setmaxnreg 40), one thread of which keeps a ring of
//     shared-memory stages full by TMA (cp.async.bulk.tensor over 2-D
//     tensor maps of the weight [K, N] and of x [M, K], 128-byte swizzle,
//     completing on the stage's mbarrier): 64 inputs x 128 channels of the
//     weight (8 KB) and the tile's BR rows of the same 64 inputs. The ring
//     is as deep as 220 KB holds, up to 16 stages (decode: 147 KB of
//     weights in flight an SM). Rows past M and inputs past K come in as
//     zeros (the maps' bounds), so any M and any K % 8 == 0 run.
//   - two consumers (setmaxnreg 232), 64 output channels each. bf16 x:
//     wgmma.mma_async with the WEIGHT as A (64 channels) from registers and
//     the tile's rows as B (N = rows, K-major, from shared memory). The
//     int8 bytes are never widened in memory: ldmatrix.trans of them as
//     16-bit pairs gives a lane the pairs (channel 2g, 2g + 1) x (input 2t,
//     2t + 1), which a byte permute into the 2^23 magic float and a permute
//     of the high halves convert to bf16 exactly: A's row g is then channel
//     2g and row g + 8 channel 2g + 1, which the epilogue undoes. A decode
//     tile is 8 * ceil(M / 8) rows, issued as one wgmma of that width or as
//     the sum of two or three (40 = 32 + 8), its k16 steps spread over 2
//     or 4 accumulator chains added at the end (at n8 each product is
//     short, and one chain waits on the last); a prefill tile is 128 or
//     256 rows, a partial last tile the narrowest product that holds it.
//     The scale is applied once in the epilogue, the outputs staged
//     through shared memory and stored 16 bytes at a time along y's rows.
//   - Split-K where the items would not fill the card (ops/int8_gemm.py
//     gemm_plan, a function of host shapes: a captured CUDA graph keeps
//     it): each split writes its f32 partial sums unscaled, and a second
//     pass (int8_weight_gemm_kernel_reduce) sums them in split order,
//     scales and rounds once. No float is added atomically: a replayed
//     graph equals an eager call bit for bit.
// The f32 form (f32 x and y: an f32 engine with int8 weights; M <= 64)
// keeps the ring, the producer and the items, and runs the products as
// 2xTF32 on mma.sync.m16n8k8 in each consumer warp (16 channels a warp):
// every int8 value is exact in TF32, so only x splits, x = hi + lo (both
// TF32), two products a step, the small one first. The same ldmatrix.trans
// words are the TF32 A fragments with A's k = t taken as input 2t and
// k = t + 4 as input 2t + 1 of each 8, so B's fragments are x's inputs 2t
// and 2t + 1 of a token: one 8-byte shared load from the x tile (f32, two
// 128-byte swizzled boxes of 32 inputs). wgmma's TF32 form wants both
// operands K-major in shared memory in that k order, which would take a
// rewrite of every x tile per stage; mma.sync reads them as they land.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWeights = 3;
constexpr int kThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kChannels = 128;  // output channels an item, 64 a consumer warpgroup
constexpr int kSlab = 64;  // inputs a stage
constexpr int kWBytes = kSlab * kChannels;  // a stage's int8 weight tile
constexpr int kMaxStages = 16;
constexpr int kSmemBudget = 220 * 1024;
// the TMA issuer's expect_tx; lane 0 of each consumer warp once its
// products that read the stage are done
constexpr int kFullArrivals = 1;
constexpr int kEmptyArrivals = 8;
// the tallest tile a K split takes (its f32 partial sums go straight out
// of the accumulators; the 256-row epilogue spills with that path)
constexpr int kMaxSplitRows = 128;
// the most K splits a launch takes (ops/int8_gemm.py _MAX_SPLITS)
constexpr int kMaxSplits = 16;
// the reduce pass's threads a block, 4 outputs a thread
constexpr int kReduceThreads = 128;

// up to three weights of one launch (the same x and K): scales, outputs
// (in x's type), f32 partial sums of a K split ([splits, M, N], or null),
// widths and channel groups of 128
struct Weights {
  const float* s[kMaxWeights];
  void* y[kMaxWeights];
  float* part[kMaxWeights];
  int N[kMaxWeights];
  int groups[kMaxWeights];
  int count;
};

// a[i] with constant indices: a runtime index into the parameter struct
// would copy it to local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxWeights], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// a stage: the weight tile [64 inputs][128 channel bytes], then BR rows of
// x: bf16 [row][64 inputs] (128 bytes a row); f32 two boxes [row][32
// inputs] one after the other. Every piece a multiple of 1,024 bytes, each
// 128-byte row's 16-byte chunk c at c ^ (row % 8)
template <int BR, bool F32>
struct Stage {
  static constexpr int kXBytes = BR * kSlab * (F32 ? 4 : 2);
  static constexpr int kBytes = kWBytes + kXBytes;
  // a bf16 consumer warpgroup's output staging: up to 64 rows x 64 channels
  static constexpr int kStagingBytes = F32 ? 0 : (BR < 64 ? BR : 64) * 128;
  static constexpr int kRing = kSmemBudget - 2 * kStagingBytes;
  static constexpr int kStages = kRing / kBytes < kMaxStages ? kRing / kBytes : kMaxStages;
  // + the 1,024-byte alignment
  static constexpr int kSmem = kStages * kBytes + 2 * kStagingBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
// bytes apart (the stride byte offset); the leading offset is unused for a
// K-major swizzled operand
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

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16: A from registers, B from
// shared memory (K-major); acc 0 overwrites d. Every output register is an
// operand.
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

// the rows of a decode tile as wgmma widths: a power of two as it is, any
// other multiple of 8 as 32 or 16 rows then the rest (40 = 32 + 8, 56 = 32
// + 16 + 8), each part on its own accumulators and 8-row groups of x
template <int NS>
__device__ __forceinline__ void rows_mma(float* acc, const uint32_t (&a)[4], uint32_t xs,
                                         int flag) {
  if constexpr ((NS & (NS - 1)) == 0) {
    wgmma_rs(Tag<NS>(), acc, a, sw128_desc(xs), flag);
  } else {
    constexpr int kTop = NS > 32 ? 32 : 16;
    rows_mma<kTop>(acc, a, xs, flag);
    rows_mma<NS - kTop>(acc + kTop / 2, a, xs + kTop * 128, flag);
  }
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

// this warp's 16 channels (16-byte chunk c16 of each row) of a stage's int8
// tile ([64 inputs][128 channel bytes], swizzled) as ldmatrix.trans words:
// q[h][m] holds inputs 32h + 8m .. + 7; a lane's word: (input 2t, channel
// 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1) of them
__device__ __forceinline__ void int8_words(uint32_t (&q)[2][4], uint32_t tile, int c16,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 32 * h + (lane >> 3) * 8 + (lane & 7);
    ldmatrix_x4_trans(q[h], tile + i * 128 + ((c16 ^ (lane & 7)) << 4));
  }
}

// the bf16 A fragments of wgmma's register form for the k16 steps ks = 0..3
// of a stage (inputs 16ks .. + 15): A's row g is channel 2g, row g + 8
// channel 2g + 1
__device__ __forceinline__ void int8_frags(uint32_t (&a)[4][4], uint32_t tile, int c16,
                                           int lane) {
  uint32_t q[2][4];
  int8_words(q, tile, c16, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      a[2 * h + st][0] = i8_pair_bf16x2(q[h][2 * st], 0, 2);
      a[2 * h + st][1] = i8_pair_bf16x2(q[h][2 * st], 1, 3);
      a[2 * h + st][2] = i8_pair_bf16x2(q[h][2 * st + 1], 0, 2);
      a[2 * h + st][3] = i8_pair_bf16x2(q[h][2 * st + 1], 1, 3);
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

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// a 16-byte store that L2 evicts first: the outputs are not read again
// here, and the weight and x tiles the other items share stay in L2
__device__ __forceinline__ void st_global_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// x = hi + lo, both TF32 (cvt.rna's rounding by bit arithmetic: hi drops its
// 13 low bits itself, the tensor cores ignore lo's)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b for one 16x8 f32 tile: a 16x8 TF32 (row), b 8x8 TF32 (col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// a work item: rows [r0, r0 + nrows) of x, weight wi and its 128 channels
// from n0, stages [k0, k1) of K split ``split``
struct Item {
  int r0, nrows, wi, n0, k0, k1, split;
};

// item -> (split, channel group, row tile), tile fastest: the items in
// flight together read a weight slab once for all its row tiles
__device__ __forceinline__ Item item_at(int item, int n_tiles, int groups, int splits, int nk,
                                        const Weights& W, int M, int br) {
  Item it;
  const int tile = item % n_tiles, rest = item / n_tiles;
  int g = rest % groups;
  it.split = rest / groups;
  it.r0 = tile * br;
  it.nrows = min(M - it.r0, br);
  it.wi = 0;
  if (W.count > 1 && g >= W.groups[0]) {
    g -= W.groups[0];
    it.wi = 1;
    if (W.count > 2 && g >= W.groups[1]) {
      g -= W.groups[1];
      it.wi = 2;
    }
  }
  it.n0 = g * kChannels;
  it.k0 = it.split * nk / splits;
  it.k1 = (it.split + 1) * nk / splits;
  return it;
}

// a tile's accumulator chains: a stage's four k16 products feed one
// accumulator in turn; at decode widths each wgmma is short and one chain
// would wait on the last, so the steps go round robin to independent
// accumulators, added in a fixed order at the end. Prefill tiles: one
template <int BR>
struct Chains {
  static constexpr int value = BR >= 128 ? 1 : (BR <= 32 ? 4 : 2);
};

// one item's products on a bf16 consumer warpgroup (cw), rows as NS-wide
// wgmma (NS >= the item's rows), then its epilogue: y, or the split's f32
// partial sums, for the warpgroup's 64 channels
template <int NS, int BR>
__device__ __forceinline__ void consume_bf16(float* acc, Ring& ring, uint32_t base,
                                             uint32_t full, uint32_t empty, uint32_t staging,
                                             const Item& it, const Weights& W, int M,
                                             int splits, int cw, int warp, int lane) {
  using S = Stage<BR, false>;
  const int nk = it.k1 - it.k0;
  int prev = 0;
  // chain c: acc + c * BR / 2, steps ks = c, c + C, ...; each chain's
  // first product overwrites
  constexpr int C = Chains<BR>::value;
  // one stage's products into acc, with a the A fragments, written here,
  // and a_prev those of the previous stage's products, which may still be
  // reading their registers until the wait below retires them: named
  // after it, they keep their registers, so a is not given them
  auto step = [&](int kt, uint32_t (&a)[4][4], const uint32_t (&a_prev)[4][4]) {
    mbar_wait(full + 8 * ring.stage, ring.phase);
    const uint32_t st = base + ring.stage * S::kBytes, xs = st + kWBytes;
    int8_frags(a, st, cw * 4 + warp, lane);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      rows_mma<NS>(acc + (ks % C) * (BR / 2), a[ks], xs + 32 * ks, kt | (ks / C));
    wgmma_commit();
    // the previous stage's products are done: its buffers go back
    wgmma_wait<1>();
    keep_alive(a_prev);
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
  keep_alive(a0);
  keep_alive(a1);
#pragma unroll
  for (int i = 0; i < C * (BR / 2); ++i) asm volatile("" : "+f"(acc[i])::"memory");
  if (lane == 0) mbar_arrive(empty + 8 * prev);
  // the chains added in order into the first
#pragma unroll
  for (int c = 1; c < C; ++c)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] += acc[c * (BR / 2) + i];

  // acc[4j + 2h + u]: A row g + 8h of the warp's 16, which is channel
  // 2g + h, and tile row 8j + 2t + u
  const int g = lane >> 2, t = lane & 3;
  const int N = pick(W.N, it.wi);
  const int chw = it.n0 + cw * 64 + warp * 16;
  const int bar_id = 1 + cw, ct = warp * 32 + lane;
  if constexpr (BR <= kMaxSplitRows) {
    // a K split: f32 partial sums, unscaled, straight out (the reduce pass
    // scales and rounds)
    if (splits > 1) {
      float* part = pick(W.part, it.wi) +
                    (static_cast<size_t>(it.split) * M + it.r0) * static_cast<size_t>(N);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = chw + 2 * g + h;
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
  }
  // y through this warpgroup's staging buffer, up to 64 rows at a time:
  // each thread puts its outputs, scaled and rounded, at [row][channel]
  // (16-byte chunk q of a row at q ^ (row % 8), so the threads of a store
  // hit distinct banks), then the warpgroup copies the rows out in 16-byte
  // pieces along the rows of y
  constexpr int kRows = NS < 64 ? NS : 64;
  const int ch = min(chw + 2 * g, N - 2);  // past N: read in bounds, never stored
  const float* sp = pick(W.s, it.wi) + ch;
  const float s0 = sp[0], s1 = sp[1];
  bf16* y = static_cast<bf16*>(pick(W.y, it.wi));
#pragma unroll
  for (int c = 0; c < NS / kRows; ++c) {
    if (c * kRows >= it.nrows) break;
    named_barrier(bar_id);  // the buffer's last rows are out
#pragma unroll
    for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = c * (kRows / 8) + jj, r = 8 * jj + 2 * t + u;
        const uint32_t row = staging + r * 128;
        const int q = warp * 2 + (g >> 2);  // channels 2g, 2g + 1 of the warp's 16
        st_shared_b32(row + ((q ^ (r & 7)) << 4) + (g & 3) * 4,
                      bf16x2_bits(acc[4 * j + u] * s0, acc[4 * j + 2 + u] * s1));
      }
    named_barrier(bar_id);  // the rows are in
    const int rows_out = min(kRows, it.nrows - c * kRows);
    bf16* out = y + static_cast<size_t>(it.r0 + c * kRows) * N + it.n0 + cw * 64;
    for (int i = ct; i < rows_out * 8; i += 128) {
      const int r = i >> 3, q = i & 7;
      if (it.n0 + cw * 64 + q * 8 < N)
        st_global_stream(out + static_cast<size_t>(r) * N + q * 8,
                         ld_shared_v4(staging + r * 128 + ((q ^ (r & 7)) << 4)));
    }
  }
}

// one item's 2xTF32 products on a consumer warp (16 channels, chunk c16 of
// the 128), then its epilogue: y, or the split's f32 partial sums
template <int BR>
__device__ __forceinline__ void consume_f32(Ring& ring, uint32_t base, uint32_t full,
                                            uint32_t empty, const Item& it, const Weights& W,
                                            int M, int splits, int c16, int lane) {
  using S = Stage<BR, true>;
  constexpr int NT = BR / 8;
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kt = it.k0; kt < it.k1; ++kt) {
    mbar_wait(full + 8 * ring.stage, ring.phase);
    const uint32_t st = base + ring.stage * S::kBytes, xs = st + kWBytes;
    uint32_t q[2][4];
    int8_words(q, st, c16, lane);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      // the k8 step of inputs 8m .. + 7: A's (row g, k t) is (channel 2g,
      // input 2t), (g + 8, t) channel 2g + 1, k t + 4 input 2t + 1
      const uint32_t u = q[m >> 2][m & 3] ^ 0x80808080u;
      const uint32_t a[4] = {i8_value(u, 0), i8_value(u, 1), i8_value(u, 2), i8_value(u, 3)};
      // x's inputs 8m + 2t, + 1 of token 8j + g: in box m / 4, byte
      // 32 (m % 4) + 8t of its 128-byte row
      const int c = 2 * (m & 3) + (t >> 1);
      const uint32_t xb = xs + (m >> 2) * BR * 128 + g * 128 + ((c ^ g) << 4) + (t & 1) * 8;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 xv = ld_shared_v2(xb + j * 1024);
        uint32_t h0, l0, h1, l1;
        split_tf32(__uint_as_float(xv.x), h0, l0);
        split_tf32(__uint_as_float(xv.y), h1, l1);
        mma_tf32(acc[j], a, l0, l1);
        mma_tf32(acc[j], a, h0, h1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ring.stage);
    ring.template advance<S::kStages>();
  }
  // acc[j][e]: channel 2g + (e >> 1) of the warp's 16, row 8j + 2t + (e & 1)
  const int N = pick(W.N, it.wi);
  const int ch0 = it.n0 + c16 * 16 + 2 * g;
  const size_t stride = static_cast<size_t>(M) * N;
  float* part = splits > 1 ? pick(W.part, it.wi) + static_cast<size_t>(it.r0) * N : nullptr;
  float* y = static_cast<float*>(pick(W.y, it.wi)) + static_cast<size_t>(it.r0) * N;
  const float* sp = pick(W.s, it.wi);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ch = ch0 + (e >> 1);
    if (ch >= N) continue;
    const float sc = sp[ch];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = 8 * j + 2 * t + (e & 1);
      if (r >= it.nrows) continue;
      if (part) {
        part[it.split * stride + static_cast<size_t>(r) * N + ch] = acc[j][e];
      } else {
        y[static_cast<size_t>(r) * N + ch] = acc[j][e] * sc;
      }
    }
  }
}

// one persistent block an SM (grid: min(SMs, items)); block 384 threads:
// warpgroup 0 the producer, 1 and 2 the consumers of channels 0-63 and
// 64-127 of each item. Items: ceil(M / BR) row tiles x the channel groups
// of all weights x the K splits, in item_at's order. BR: the tile height;
// F32: x's and y's type is float (the 2xTF32 form), else bf16.
template <int BR, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
int8_weight_gemm_kernel(const __grid_constant__ CUtensorMap map0,
                        const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map2,
                        const __grid_constant__ CUtensorMap xmap, const Weights W, int M, int K,
                        int splits) {
  using S = Stage<BR, F32>;
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
  const int n_tiles = (M + BR - 1) / BR;
  const int groups = W.groups[0] + (W.count > 1 ? W.groups[1] : 0) +
                     (W.count > 2 ? W.groups[2] : 0);
  const int nk = (K + kSlab - 1) / kSlab;
  const int n_items = n_tiles * groups * splits;
  Ring ring{0, 0};

  // the warpgroup, made warp-uniform for the compiler: each role is a
  // region of its own, under its own register budget
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {
    // the producer: one thread issues a stage's TMA copies, the weight
    // tile and the tile's BR rows of x (rows past M and inputs past K
    // arrive as zeros and count in the bytes), and the bytes the stage's
    // barrier expects
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = item_at(item, n_tiles, groups, splits, nk, W, M, BR);
        const CUtensorMap* map = it.wi == 0 ? &map0 : (it.wi == 1 ? &map1 : &map2);
        for (int kt = it.k0; kt < it.k1; ++kt) {
          mbar_wait(empty + 8 * ring.stage, ring.phase ^ 1);
          const uint32_t st = base + ring.stage * S::kBytes, bar = full + 8 * ring.stage;
          const int k = kt * kSlab;
          mbar_expect_tx(bar, S::kBytes);
          tma_load_2d(st, map, it.n0, k, bar);
          tma_load_2d(st + kWBytes, &xmap, k, it.r0, bar);
          if constexpr (F32) tma_load_2d(st + kWBytes + BR * 128, &xmap, k + 32, it.r0, bar);
          ring.template advance<S::kStages>();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
    if constexpr (F32) {
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = item_at(item, n_tiles, groups, splits, nk, W, M, BR);
        consume_f32<BR>(ring, base, full, empty, it, W, M, splits, cw * 4 + warp, lane);
      }
    } else {
      const uint32_t staging = base + S::kStages * S::kBytes + cw * S::kStagingBytes;
      float acc[Chains<BR>::value * (BR / 2)];
#pragma unroll
      for (int i = 0; i < Chains<BR>::value * (BR / 2); ++i) acc[i] = 0.f;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = item_at(item, n_tiles, groups, splits, nk, W, M, BR);
        // a partial last tile runs the narrowest product that holds its rows
        if constexpr (BR >= 128) {
          if (it.nrows <= BR / 4) {
            consume_bf16<BR / 4, BR>(acc, ring, base, full, empty, staging, it, W, M, splits,
                                     cw, warp, lane);
            continue;
          }
          if (it.nrows <= BR / 2) {
            consume_bf16<BR / 2, BR>(acc, ring, base, full, empty, staging, it, W, M, splits,
                                     cw, warp, lane);
            continue;
          }
        }
        consume_bf16<BR, BR>(acc, ring, base, full, empty, staging, it, W, M, splits, cw, warp,
                             lane);
      }
    }
  }
}

// a K split's second pass: y = (the splits' f32 partial sums added in
// split order) * s, rounded once, 4 outputs of one row a thread, every
// split's partials requested before the first add. grid (the widest
// weight's M * N / 4 outputs over kReduceThreads, the weights), block
// kReduceThreads
template <typename YT>
__global__ void __launch_bounds__(kReduceThreads)
int8_weight_gemm_kernel_reduce(const Weights W, int M, int splits) {
  const int wi = blockIdx.y, N = pick(W.N, wi);
  const size_t stride = static_cast<size_t>(M) * N;
  const size_t at = 4 * (static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x);
  if (at >= stride) return;
  const float* p = pick(W.part, wi) + at;
  float4 v[kMaxSplits];
#pragma unroll
  for (int k = 0; k < kMaxSplits; ++k)
    if (k < splits) v[k] = *reinterpret_cast<const float4*>(p + k * stride);
  float4 sum = v[0];
#pragma unroll
  for (int k = 1; k < kMaxSplits; ++k)
    if (k < splits) sum.x += v[k].x, sum.y += v[k].y, sum.z += v[k].z, sum.w += v[k].w;
  // N % 16 == 0: the 4 outputs are channels of one row
  const float4 sc = *reinterpret_cast<const float4*>(pick(W.s, wi) + at % N);
  YT* y = static_cast<YT*>(pick(W.y, wi)) + at;
  if constexpr (std::is_same<YT, float>::value) {
    *reinterpret_cast<float4*>(y) = make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
  } else {
    *reinterpret_cast<uint2*>(y) =
        make_uint2(bf16x2_bits(sum.x * sc.x, sum.y * sc.y), bf16x2_bits(sum.z * sc.z, sum.w * sc.w));
  }
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

// a TMA map of a row-major [outer, inner] array of elem_bytes-wide
// elements, boxes of box_outer rows x box_inner elements (128 bytes),
// 128-byte swizzle; what lies outside the array reads as zeros
cudaError_t tile_map(CUtensorMap* map, const void* p, CUtensorMapDataType type, int elem_bytes,
                     uint64_t outer, uint64_t inner, uint32_t box_outer, uint32_t box_inner) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * elem_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a map made once per key and kept: the weights' (address, K, N) and x's
// (address, M, K, tile rows, type; the allocator hands the same addresses
// back, and a captured graph keeps its own), since a map holds nothing but
// the address, the dims, the strides and the box, so a reused address of
// the same shape maps alike. Encoding one costs host time on every eager
// call
using MapKey = std::tuple<uintptr_t, int, int, int, int>;

template <typename Encode>
cudaError_t cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  static std::mutex mu;
  static std::map<MapKey, CUtensorMap> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto found = cache.find(key);
  if (found != cache.end()) {
    *map = found->second;
    return cudaSuccess;
  }
  const cudaError_t err = encode(map);
  if (err == cudaSuccess) {
    if (cache.size() >= 4096) cache.clear();
    cache.emplace(key, *map);
  }
  return err;
}

// a weight's map, [K, N] int8 in boxes of 64 inputs x 128 channels
cudaError_t weight_map(CUtensorMap* map, const void* q, int K, int N) {
  return cached_map(map, MapKey(reinterpret_cast<uintptr_t>(q), K, N, 0, 0),
                    [&](CUtensorMap* m) {
                      return tile_map(m, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kSlab, 128);
                    });
}

// x's map, [M, K] in boxes of BR rows x 128 bytes of inputs
cudaError_t x_map(CUtensorMap* map, const void* x, int M, int K, int BR, bool f32) {
  return cached_map(map, MapKey(reinterpret_cast<uintptr_t>(x), M, K, BR, f32 ? 1 : 2),
                    [&](CUtensorMap* m) {
                      return f32 ? tile_map(m, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, BR,
                                            32)
                                 : tile_map(m, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BR,
                                            64);
                    });
}

template <int BR, bool F32>
cudaError_t launch(const void* x, const Weights& W, const CUtensorMap (&maps)[kMaxWeights], int M,
                   int K, int splits, cudaStream_t stream) {
  using S = Stage<BR, F32>;
  auto kernel = int8_weight_gemm_kernel<BR, F32>;
  // once per instantiation: the attribute outlives the call
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (smem_set != cudaSuccess) return smem_set;
  CUtensorMap xmap;
  cudaError_t err = x_map(&xmap, x, M, K, BR, F32);
  if (err != cudaSuccess) return err;
  int groups = 0, widest = 0;
  for (int i = 0; i < W.count; ++i) groups += W.groups[i], widest = max(widest, W.N[i]);
  const int items = (M + BR - 1) / BR * groups * splits;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kernel<<<min(sms, items), kThreads, S::kSmem, stream>>>(maps[0], maps[1], maps[2], xmap, W, M,
                                                           K, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = (M * widest / 4 + kReduceThreads - 1) / kReduceThreads;
  using YT = typename std::conditional<F32, float, bf16>::type;
  int8_weight_gemm_kernel_reduce<YT><<<dim3(blocks, W.count, 1), kReduceThreads, 0, stream>>>(
      W, M, splits);
  return cudaGetLastError();
}

template <bool F32>
cudaError_t dispatch(int br, const void* x, const Weights& W,
                     const CUtensorMap (&maps)[kMaxWeights], int M, int K, int splits,
                     cudaStream_t st) {
#define GEMM_LAUNCH(BR) launch<BR, F32>(x, W, maps, M, K, splits, st)
  switch (br) {
    case 8: return GEMM_LAUNCH(8);
    case 16: return GEMM_LAUNCH(16);
    case 24: return GEMM_LAUNCH(24);
    case 32: return GEMM_LAUNCH(32);
    case 40: return GEMM_LAUNCH(40);
    case 48: return GEMM_LAUNCH(48);
    case 56: return GEMM_LAUNCH(56);
    case 64: return GEMM_LAUNCH(64);
    default: break;
  }
  if constexpr (!F32) {
    if (br == 128) return GEMM_LAUNCH(128);
    if (br == 256) return GEMM_LAUNCH(256);
  }
  return cudaErrorInvalidValue;
#undef GEMM_LAUNCH
}

}  // namespace

// y_i [M, N_i] = (x [M, K] @ q_i [K, N_i]) * s_i [N_i] for the count (1..3)
// weights given, in one call; x and y_i bf16 (dtype 1) or f32 (dtype 0,
// the 2xTF32 form), q_i int8 in the JAX layout, s_i f32. br: the row tile,
// 8..64 in steps of 8 (a decode tile) or, bf16 only, 128 or 256 (a prefill
// tile). splits: K splits, at most 16 and ceil(K / 64), more than 1 only with br
// <= 128 and M <= br, and then p_i an f32 scratch [splits, M, N_i] each (the
// reduce pass follows the kernel on the stream). K % 8 == 0, N_i % 16 == 0,
// x and q_i 16-byte aligned. Returns the CUDA error of the launches (0 =
// launched).
extern "C" int b2b_int8_weight_gemm(const void* x, int dtype, int count, const void* q0,
                                    const void* s0, void* y0, void* p0, int N0, const void* q1,
                                    const void* s1, void* y1, void* p1, int N1, const void* q2,
                                    const void* s2, void* y2, void* p2, int N2, int M, int K,
                                    int br, int splits, void* stream) {
  const bool f32 = dtype == 0;
  if (M < 1 || K < 8 || K % 8 != 0 || count < 1 || count > kMaxWeights ||
      (dtype != 0 && dtype != 1) || splits < 1 || splits > kMaxSplits ||
      splits > (K + kSlab - 1) / kSlab || (splits > 1 && (br > kMaxSplitRows || M > br)) ||
      (f32 && br > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* qs[kMaxWeights] = {q0, q1, q2};
  const void* ss[kMaxWeights] = {s0, s1, s2};
  void* ys[kMaxWeights] = {y0, y1, y2};
  void* ps[kMaxWeights] = {p0, p1, p2};
  const int Ns[kMaxWeights] = {N0, N1, N2};
  Weights W = {};
  W.count = count;
  CUtensorMap maps[kMaxWeights];
  for (int i = 0; i < count; ++i) {
    if (Ns[i] < 16 || Ns[i] % 16 != 0 || (splits > 1 && ps[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    W.s[i] = static_cast<const float*>(ss[i]);
    W.y[i] = ys[i];
    W.part[i] = splits > 1 ? static_cast<float*>(ps[i]) : nullptr;
    W.N[i] = Ns[i];
    W.groups[i] = (Ns[i] + kChannels - 1) / kChannels;
    const cudaError_t err = weight_map(&maps[i], qs[i], K, Ns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = count; i < kMaxWeights; ++i) maps[i] = maps[0];  // never read
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = f32 ? dispatch<true>(br, x, W, maps, M, K, splits, st)
                              : dispatch<false>(br, x, W, maps, M, K, splits, st);
  return static_cast<int>(err);
}
