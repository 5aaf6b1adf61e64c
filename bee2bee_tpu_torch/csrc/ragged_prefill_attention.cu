// Ragged paged attention of prefill chunks for Hopper (sm_90a), on the
// tensor cores: causal GQA attention of a [B, T] query chunk read
// straight from the paged KV pool through per-row block tables.
//
// Replaces the TPU kernel bee2bee_tpu/ops/ragged.py:_ragged_kernel in two
// kernels, each in both pool forms (the pool in q's type, and the int8
// pool whose pages carry one f32 scale per (kv head, block)); ops/ragged.py
// dispatches:
//   ragged_prefill_kernel      bf16 chunks of T >= T_MIN queries (bf16
//                              decode has the split-K kernel of
//                              ragged_decode_attention.cu);
//   ragged_prefill_f32_kernel  f32 queries of T >= T_MIN_F32 (1: decode
//                              included), over an int8 pool of T >=
//                              T_MIN_F32_INT8 (below); at head_dim 256
//                              of T >= T_MIN_F32_HD256 and
//                              T_MIN_F32_INT8_HD256.
// Shorter f32 chunks keep the row-per-warp kernel of ragged_attention.cu.
// Same function: per-row `offset`, one sliding `window` per call (0 = full
// causal), `sm_scale`, tanh `softcap` applied before the mask; pages past
// the causal frontier or wholly below the window are skipped; a row that
// sees nothing writes 0. The bf16 kernel runs both products as the JAX
// kernel runs them on its matrix unit: bf16 operands, f32 accumulation, P
// rounded to bf16 before P V. An int8 page is dequantized in f32 with its
// scale (k_scale[kvh * NB + blk], read beside tables[b, j]) and rounded to
// bf16.
//
// What bounds it on an H100: a prefill chunk does 4 * HD flops per
// visible (query, key) pair per head and reads each visible page once per
// kv head, far above the ~295 flops/byte where the tensor cores rather
// than the memory are the limit (T=512 at offset 1000 over llama-3-8b's
// heads: 1.05e10 flops, 0.0107 ms at 989 TFLOP/s bf16). So it is bound by
// operations, and the design keeps the tensor cores fed:
//   grid  (B * Hkv, ceil(G * T / 64)); a block of 4 warps owns 64 query
//         rows of one (batch row, kv head), rows folded (t major, g
//         minor) so one staged page serves the whole GQA group; the
//         blocks with the latest (longest) rows start first;
//   stage each key tile of 64 keys (64 / BS pages, each contiguous in the
//         pool) with 16-byte cp.async copies, double-buffered so the next
//         tile's pages load while this one computes; the block reads
//         tables[b, j] itself. A page the block's rows cannot see (past
//         the frontier of its last row, wholly below the window of its
//         first) is not read: its slots are zero-filled;
//   int8  pages land as bytes and are dequantized once per block into a
//         bf16 tile in shared memory (the row kernel dequantizes them
//         once per query row);
//   math  mma.sync m16n8k16 tiles and the online softmax of
//         tile_attention.cuh.
// At HD 256 (the gemma family's heads) the bf16 kernel is laid out anew,
// since Q's fragments, the accumulator and S would need about 224
// registers a lane: Q [64][256] bf16 (32 KB) stays resident in shared
// memory and each warp loads a k-step's fragment where it uses it, and the
// key tiles hold 32 keys (16 KB each of K and V), so a lane holds the
// 128-register accumulator, 16 of S and little else, with no spill. Two
// stages of K and V beside Q take 96 KB (the int8 pool: the bf16 pair and
// two int8 stages, the same), so two blocks share an SM.
//
// The f32 form keeps that grid, page walk and masking over 32-key f32
// tiles (the pages of an int8 pool dequantized once per block into f32:
// int8 * scale, and "rounded to q's type" is the identity), with both
// products in 3xTF32 on mma.sync m16n8k8 and P kept in f32
// (tile_attention_f32.cuh). Its bound is max(bytes / 3.35 TB/s, 3 * 4 * HD
// flops per visible pair / 494.7 TFLOP/s TF32): a prefill chunk is bound
// by the three products (T=512 at offset 1000: 0.064 ms), a decode step
// by the f32 (or int8) pages it reads.
// Both forms are instantiated for HD 64, 96, 128 and 256 and BS 8, 16 and
// 32, HD 96 and HD 256 each in a library of its own
// (ragged_prefill_attention_hd96.cu and _hd256.cu compile this file with
// RAGGED_PREFILL_HD96 or RAGGED_PREFILL_HD256), so that the three nvcc
// runs, the slowest of the build, go in parallel.
// At HD 96 (phi-3's heads) the bf16 form keeps Q in registers as at
// 128, over rows of 12 16-byte chunks in tile_attention.cuh's split
// swizzle; the f32 form's padded rows (104 and 100 floats) keep its loads
// free of bank conflicts as at the other head_dims.
// The f32 form keeps Q in shared memory at every HD; at 256 its 64 x 264
// f32 Q tile and two stages of K and V take 197 KB (one block per SM) and
// ptxas fits its 128 accumulator registers a lane beside the splits
// without spilling.

#include <type_traits>

#include "tile_attention.cuh"
#include "tile_attention_f32.cuh"

namespace {

using tile::bf16;
using tile::kKeys;
using tile::kRows;
using tile::q_resident;
using tile::tile_keys;
using tile::kThreads;
using tile::cp_async16;

struct PrefillArgs {
  const void* q;         // [B, T, H, HD] bf16, or f32 for the f32 form
  const void* k_pool;    // [Hkv, NB, BS, HD] in q's type, or int8 with scales
  const void* v_pool;
  const float* k_scale;  // [Hkv, NB] scales of an int8 pool, else nullptr
  const float* v_scale;
  const int* tables;     // [B, MB]
  const int* offset;     // [B]: position of q[b, 0]
  void* out;             // [B, T, H * HD] in q's type
  int B, T, H, Hkv, NB, MB, window;
  float sm_scale, softcap;
};

// The block's geometry: its rows, its batch row and kv head, the key range
// its rows see ([kmin, kmax], absolute positions) and the key tiles of
// KEYS keys that cover it.
struct Block {
  int b, kvh, G, nrows, r0, off, kmin, kmax, jlo, jhi;
};

template <int BS, int KEYS = kKeys>
__device__ __forceinline__ Block block_geometry(const PrefillArgs& a) {
  Block k;
  k.b = blockIdx.x / a.Hkv;
  k.kvh = blockIdx.x % a.Hkv;
  k.G = a.H / a.Hkv;
  k.nrows = k.G * a.T;
  // the longest rows first: tile y of the grid is row tile gridDim.y-1-y
  k.r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  k.off = a.offset[k.b];
  const int tlo = k.r0 / k.G;
  const int thi = (min(k.r0 + kRows, k.nrows) - 1) / k.G;
  // ops/ragged.py's two skip predicates for the block's rows, and no key
  // past the table: keys there are absent
  k.kmax = min(k.off + thi, a.MB * BS - 1);
  k.kmin = a.window > 0 ? max(k.off + tlo - a.window + 1, 0) : 0;
  k.jlo = k.kmin / KEYS;
  k.jhi = k.kmax >= k.kmin ? k.kmax / KEYS : k.jlo - 1;
  return k;
}

// The lane's two rows, of the 16 from row0 of the block's tile: their key
// ranges and output rows (O: q's type).
template <int HD, int BS, typename O>
__device__ __forceinline__ tile::RowSpan lane_rows(const PrefillArgs& a,
                                                   const Block& k, int row0,
                                                   int lane,
                                                   O* (&dst)[2]) {
  int kmin[2], kmax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = k.r0 + row0 + (lane >> 2) + 8 * i;
    kmin[i] = 0;
    kmax[i] = -1;
    dst[i] = nullptr;
    if (R < k.nrows) {
      const int t = R / k.G;
      const int pos = k.off + t;
      kmax[i] = min(pos, a.MB * BS - 1);
      kmin[i] = a.window > 0 ? max(pos - a.window + 1, 0) : 0;
      dst[i] = static_cast<O*>(a.out) +
               ((size_t)(k.b * a.T + t) * a.H + k.kvh * k.G + R % k.G) * HD;
    }
  }
  return tile::warp_span(kmin, kmax);
}

// Table entry of tile row r of key tile j (KEYS keys a tile), or -1 for a
// page the block does not read
template <int BS, int KEYS = kKeys>
__device__ __forceinline__ int page_block(const PrefillArgs& a, const Block& k,
                                          int j, int r) {
  const int page = j * (KEYS / BS) + r / BS;
  const int pos0 = page * BS;
  if (pos0 > k.kmax || pos0 + BS - 1 < k.kmin) return -1;
  return a.tables[k.b * a.MB + page];
}

// Stage key tile j (KEYS keys) of a bf16 pool into ks/vs (swizzled).
template <int HD, int BS, int KEYS = kKeys>
__device__ __forceinline__ void stage_bf16(const PrefillArgs& a, const Block& k,
                                           int j, uint4* ks, uint4* vs) {
  constexpr int RC = HD / 8;
  const bf16* kp = static_cast<const bf16*>(a.k_pool);
  const bf16* vp = static_cast<const bf16*>(a.v_pool);
  for (int id = threadIdx.x; id < KEYS * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int blk = page_block<BS, KEYS>(a, k, j, r);
    size_t src = 0;
    if (blk >= 0) src = (((size_t)k.kvh * a.NB + blk) * BS + r % BS) * HD + c * 8;
    const int n = blk >= 0 ? 16 : 0;
    cp_async16(ks + tile::swz<HD>(r, c), kp + src, n);
    cp_async16(vs + tile::swz<HD>(r, c), vp + src, n);
  }
}

// Stage key tile j (KEYS keys) of an int8 pool as bytes into kq/vq
// ([KEYS][HD], plain) and its pages' scales into sc[0] (K) / sc[1] (V); a
// page the block does not read gets zeros and scale 0.
template <int HD, int BS, int KEYS = kKeys>
__device__ __forceinline__ void stage_int8(const PrefillArgs& a, const Block& k,
                                           int j, uint4* kq, uint4* vq,
                                           float (*sc)[KEYS / BS]) {
  constexpr int RC = HD / 16;
  const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
  const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
  for (int id = threadIdx.x; id < KEYS * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int blk = page_block<BS, KEYS>(a, k, j, r);
    size_t src = 0;
    if (blk >= 0) src = (((size_t)k.kvh * a.NB + blk) * BS + r % BS) * HD + c * 16;
    const int n = blk >= 0 ? 16 : 0;
    cp_async16(kq + id, kp + src, n);
    cp_async16(vq + id, vp + src, n);
  }
  if (threadIdx.x < KEYS / BS) {
    const int blk = page_block<BS, KEYS>(a, k, j, threadIdx.x * BS);
    sc[0][threadIdx.x] = blk >= 0 ? a.k_scale[k.kvh * a.NB + blk] : 0.f;
    sc[1][threadIdx.x] = blk >= 0 ? a.v_scale[k.kvh * a.NB + blk] : 0.f;
  }
}

// 16 int8 values times their page's scale in f32, each rounded to bf16
// (the JAX kernel's (k * scale).astype(q.dtype)), as two 16-byte chunks
__device__ __forceinline__ void dequant16(uint4 x, float scale, uint4& lo,
                                          uint4& hi) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&x);
  uint32_t* o0 = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* o1 = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o0[e] = tile::pack_bf16(v[2 * e] * scale, v[2 * e + 1] * scale);
    o1[e] = tile::pack_bf16(v[8 + 2 * e] * scale, v[8 + 2 * e + 1] * scale);
  }
}

// Dequantize a staged int8 tile (KEYS keys) into the bf16 tiles ks/vs
// (swizzled).
template <int HD, int BS, int KEYS = kKeys>
__device__ __forceinline__ void dequant_tile(const uint4* kq, const uint4* vq,
                                             const float (*sc)[KEYS / BS],
                                             uint4* ks, uint4* vs) {
  constexpr int RC = HD / 16;
  for (int id = threadIdx.x; id < KEYS * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    uint4 lo, hi;
    dequant16(kq[id], sc[0][r / BS], lo, hi);
    ks[tile::swz<HD>(r, 2 * c)] = lo;
    ks[tile::swz<HD>(r, 2 * c + 1)] = hi;
    dequant16(vq[id], sc[1][r / BS], lo, hi);
    vs[tile::swz<HD>(r, 2 * c)] = lo;
    vs[tile::swz<HD>(r, 2 * c + 1)] = hi;
  }
}

// shared memory, per pool form, with KEYS = tile_keys<HD>() keys a tile:
//   bf16: 2 stages of K, V [KEYS][HD] bf16;
//   int8: one bf16 K, V tile, 2 stages of K, V [KEYS][HD] int8, scales.
// Q [kRows][HD] bf16 either passes through a K tile that is not in use yet
// (the second stage's, or the int8 form's bf16 one: every warp has read it
// into registers before the first copy into that tile), or, at HD 256,
// stays resident in a tile of its own ahead of them.
static_assert(kRows == kKeys, "Q is staged in a K tile");

template <int HD, int BS, bool INT8>
constexpr size_t smem_bytes() {
  constexpr int KEYS = tile_keys<HD>();
  const size_t tilebf = (size_t)KEYS * HD * 2;
  const size_t qbytes = q_resident<HD>() ? (size_t)kRows * HD * 2 : 0;
  if (!INT8) return qbytes + 2 * 2 * tilebf;
  return qbytes + 2 * tilebf + 2 * 2 * (size_t)KEYS * HD +
         2 * 2 * (KEYS / BS) * 4;
}

template <int HD, int BS, bool INT8>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const PrefillArgs a) {
  constexpr bool QS = q_resident<HD>();  // Q stays in shared memory
  constexpr int KEYS = tile_keys<HD>();
  constexpr int TILE = KEYS * HD / 8;    // uint4 chunks of a bf16 K or V tile
  constexpr int TILE8 = KEYS * HD / 16;  // the same of an int8 tile
  extern __shared__ __align__(16) unsigned char smem[];
  // bf16 tiles [stage][K, V], after the resident Q tile at HD 256
  uint4* kv = reinterpret_cast<uint4*>(smem) + (QS ? kRows * HD / 8 : 0);
  // int8 form: one bf16 tile pair, then the int8 stages [stage][K, V]
  uint4* q8 = kv + 2 * TILE;
  float(*sc)[2][KEYS / BS] =
      reinterpret_cast<float(*)[2][KEYS / BS]>(q8 + 2 * 2 * TILE8);
  uint4* qs = QS ? reinterpret_cast<uint4*>(smem) : INT8 ? kv : kv + 2 * TILE;

  const Block k = block_geometry<BS, KEYS>(a);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  tile::stage_q<HD>(qs, static_cast<const bf16*>(a.q), k.b, k.kvh, a.T, a.H, k.G,
                    k.r0, k.nrows);
  if (k.jlo <= k.jhi) {
    if constexpr (INT8)
      stage_int8<HD, BS, KEYS>(a, k, k.jlo, q8, q8 + TILE8, sc[0]);
    else
      stage_bf16<HD, BS, KEYS>(a, k, k.jlo, kv, kv + TILE);
  }
  tile::cp_async_commit();
  tile::cp_async_wait_all();
  __syncthreads();

  // Q's fragments in registers, or the accumulator alone (Q resident)
  std::conditional_t<QS, tile::WarpAcc<HD>, tile::WarpRows<HD>> w;
  if constexpr (QS)
    tile::init_acc<HD>(w);
  else
    tile::init_rows<HD>(w, qs, warp, lane);
  const uint4* qw = qs + warp * 16 * (HD / 8);  // the warp's rows of Q
  bf16* dst[2];
  const tile::RowSpan sp = lane_rows<HD, BS, bf16>(a, k, warp * 16, lane, dst);

  for (int j = k.jlo; j <= k.jhi; ++j) {
    const int st = (j - k.jlo) & 1;
    // tile j has landed; every warp is done with tile j - 1
    tile::cp_async_wait_all();
    __syncthreads();
    const uint4* ks;
    const uint4* vs;
    if constexpr (INT8) {
      const uint4* kq = q8 + st * 2 * TILE8;
      dequant_tile<HD, BS, KEYS>(kq, kq + TILE8, sc[st], kv, kv + TILE);
      if (j < k.jhi) {
        uint4* nq = q8 + (st ^ 1) * 2 * TILE8;
        stage_int8<HD, BS, KEYS>(a, k, j + 1, nq, nq + TILE8, sc[st ^ 1]);
      }
      tile::cp_async_commit();
      __syncthreads();
      ks = kv;
      vs = kv + TILE;
    } else {
      if (j < k.jhi)
        stage_bf16<HD, BS, KEYS>(a, k, j + 1, kv + (st ^ 1) * 2 * TILE,
                                 kv + (st ^ 1) * 2 * TILE + TILE);
      tile::cp_async_commit();
      ks = kv + st * 2 * TILE;
      vs = ks + TILE;
    }
    int lo[2], hi[2];
    const unsigned live = tile::tile_ranges<KEYS>(sp, j * KEYS, lo, hi);
    if constexpr (QS)
      tile::attend_tile<HD>(w, qw, ks, vs, live, lo, hi, a.sm_scale, a.softcap,
                            lane);
    else
      tile::attend_tile<HD>(w, ks, vs, live, lo, hi, a.sm_scale, a.softcap, lane);
  }
  tile::store_rows<HD>(w, dst, lane);
}


// ------------------------------------------------------------ f32 form

// The f32 form: f32 queries over an f32 pool, or over an int8 pool whose
// pages dequantize in f32 (int8 * scale; "rounded to q's type" is the
// identity in f32). The same page walk, window, softcap, scale, null-block
// and dead-row handling as the bf16 kernel, over 32-key f32 tiles with
// tile_attention_f32.cuh's 3xTF32 products.
using tile32::qk_stride;
using tile32::v_stride;
constexpr int kKeys32 = tile32::kKeys;

// Stage f32 key tile j into the padded K and V tiles.
template <int HD, int BS>
__device__ __forceinline__ void stage_f32(const PrefillArgs& a, const Block& k,
                                          int j, float* ks, float* vs) {
  constexpr int RC = HD / 4;  // 16-byte chunks per row
  const float* kp = static_cast<const float*>(a.k_pool);
  const float* vp = static_cast<const float*>(a.v_pool);
  for (int id = threadIdx.x; id < kKeys32 * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int blk = page_block<BS, kKeys32>(a, k, j, r);
    size_t src = 0;
    if (blk >= 0) src = (((size_t)k.kvh * a.NB + blk) * BS + r % BS) * HD + c * 4;
    const int n = blk >= 0 ? 16 : 0;
    cp_async16(ks + r * qk_stride<HD>() + c * 4, kp + src, n);
    cp_async16(vs + r * v_stride<HD>() + c * 4, vp + src, n);
  }
}

// 16 int8 values times their page's scale, in f32, at dst (16-byte
// aligned)
__device__ __forceinline__ void dequant16_f32(uint4 x, float scale, float* dst) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    reinterpret_cast<float4*>(dst)[e] =
        make_float4(v[4 * e] * scale, v[4 * e + 1] * scale, v[4 * e + 2] * scale,
                    v[4 * e + 3] * scale);
}

// Dequantize a staged int8 tile into the f32 tiles ks/vs (padded).
template <int HD, int BS>
__device__ __forceinline__ void dequant_tile_f32(const uint4* kq, const uint4* vq,
                                                 const float (*sc)[kKeys32 / BS],
                                                 float* ks, float* vs) {
  constexpr int RC = HD / 16;
  for (int id = threadIdx.x; id < kKeys32 * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    dequant16_f32(kq[id], sc[0][r / BS], ks + r * qk_stride<HD>() + c * 16);
    dequant16_f32(vq[id], sc[1][r / BS], vs + r * v_stride<HD>() + c * 16);
  }
}

// shared memory of the f32 form, after Q [kRows][HD + 8] f32:
//   f32 pool:  2 stages of K [32][HD + 8], V [32][HD + 4] f32;
//   int8 pool: one f32 K, V tile pair, 2 stages of K, V [32][HD] int8,
//              scales.
template <int HD, int BS, bool INT8>
constexpr size_t smem_bytes_f32() {
  const size_t pair = 4 * (size_t)(tile32::k_tile<HD>() + tile32::v_tile<HD>());
  const size_t q = 4 * (size_t)tile32::q_tile<HD>();
  if (!INT8) return q + 2 * pair;
  return q + pair + 2 * 2 * (size_t)kKeys32 * HD + 2 * 2 * (kKeys32 / BS) * 4;
}

template <int HD, int BS, bool INT8>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_f32_kernel(const PrefillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KT = tile32::k_tile<HD>();  // floats of a K tile
  constexpr int PAIR = KT + tile32::v_tile<HD>();
  constexpr int Q8 = kKeys32 * HD / 16;     // uint4 chunks of an int8 tile
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + tile32::q_tile<HD>();    // f32 tiles: [stage][K, V]
  // int8 form: one f32 tile pair, then the int8 stages [stage][K, V]
  uint4* q8 = reinterpret_cast<uint4*>(kv + PAIR);
  float(*sc)[2][kKeys32 / BS] =
      reinterpret_cast<float(*)[2][kKeys32 / BS]>(q8 + 2 * 2 * Q8);

  const Block k = block_geometry<BS, kKeys32>(a);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  tile32::stage_q<HD>(qs, static_cast<const float*>(a.q), k.b, k.kvh, a.T, a.H,
                      k.G, k.r0, k.nrows);
  if (k.jlo <= k.jhi) {
    if constexpr (INT8)
      stage_int8<HD, BS, kKeys32>(a, k, k.jlo, q8, q8 + Q8, sc[0]);
    else
      stage_f32<HD, BS>(a, k, k.jlo, kv, kv + KT);
  }
  tile::cp_async_commit();

  tile32::WarpRows<HD> w;
  tile32::init_rows<HD>(w);
  // rows that fit one warp (decode): every warp takes them, each with its
  // own quarter of the keys
  const bool ksplit = k.nrows - k.r0 <= 16;
  const int row0 = ksplit ? 0 : warp * 16;
  float* dst[2];
  const tile::RowSpan sp = lane_rows<HD, BS, float>(a, k, row0, lane, dst);
  if (ksplit && warp) dst[0] = dst[1] = nullptr;

  for (int j = k.jlo; j <= k.jhi; ++j) {
    const int st = (j - k.jlo) & 1;
    // tile j (and Q) has landed; every warp is done with tile j - 1
    tile::cp_async_wait_all();
    __syncthreads();
    const float* ks;
    if constexpr (INT8) {
      const uint4* kq = q8 + st * 2 * Q8;
      dequant_tile_f32<HD, BS>(kq, kq + Q8, sc[st], kv, kv + KT);
      if (j < k.jhi) {
        uint4* nq = q8 + (st ^ 1) * 2 * Q8;
        stage_int8<HD, BS, kKeys32>(a, k, j + 1, nq, nq + Q8, sc[st ^ 1]);
      }
      tile::cp_async_commit();
      __syncthreads();
      ks = kv;
    } else {
      if (j < k.jhi)
        stage_f32<HD, BS>(a, k, j + 1, kv + (st ^ 1) * PAIR,
                          kv + (st ^ 1) * PAIR + KT);
      tile::cp_async_commit();
      ks = kv + st * PAIR;
    }
    int lo[2], hi[2];
    unsigned live = tile32::tile_ranges(sp, j * kKeys32, lo, hi);
    if (ksplit) live &= 1u << warp;
    tile32::attend_tile<HD>(w, qs, ks, ks + KT, live, lo, hi, a.sm_scale,
                            a.softcap, row0, lane);
  }
  tile::cp_async_wait_all();  // no copy in flight (an empty walk: Q's)
  if (ksplit) {
    static_assert(tile32::merge_floats<HD>() <= tile32::q_tile<HD>(),
                  "the merge fits in the Q tile");
    __syncthreads();  // every warp is done with Q and the last tile
    tile32::merge_warps<HD>(w, qs, warp, lane);
  }
  tile32::store_rows<HD>(w, dst, lane);
}

// The launch of either form (F32: the f32 one), instantiated for BS 8, 16
// and 32 at the head_dims launch_hd takes.
template <int HD, int BS, bool INT8, bool F32>
int launch(const PrefillArgs& a, cudaStream_t stream) {
  const int tiles = (a.H / a.Hkv * a.T + kRows - 1) / kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.B * a.Hkv, tiles);
  constexpr size_t smem =
      F32 ? smem_bytes_f32<HD, BS, INT8>() : smem_bytes<HD, BS, INT8>();
  auto kernel = F32 ? ragged_prefill_f32_kernel<HD, BS, INT8>
                    : ragged_prefill_kernel<HD, BS, INT8>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, bool INT8, bool F32>
int launch_bs(int BS, const PrefillArgs& a, cudaStream_t stream) {
  switch (BS) {
    case 8:
      return launch<HD, 8, INT8, F32>(a, stream);
    case 16:
      return launch<HD, 16, INT8, F32>(a, stream);
    case 32:
      return launch<HD, 32, INT8, F32>(a, stream);
  }
  return -1;
}

// the head_dims this library is built for: 64 and 128, or with
// RAGGED_PREFILL_HD96 defined (ragged_prefill_attention_hd96.cu) 96 alone,
// or with RAGGED_PREFILL_HD256 (ragged_prefill_attention_hd256.cu) 256
// alone, so that the three parts compile in parallel
template <bool INT8, bool F32>
int launch_hd(int hd, int BS, const PrefillArgs& a, cudaStream_t stream) {
  switch (hd) {
#if defined(RAGGED_PREFILL_HD96)
    case 96:
      return launch_bs<96, INT8, F32>(BS, a, stream);
#elif defined(RAGGED_PREFILL_HD256)
    case 256:
      return launch_bs<256, INT8, F32>(BS, a, stream);
#else
    case 64:
      return launch_bs<64, INT8, F32>(BS, a, stream);
    case 128:
      return launch_bs<128, INT8, F32>(BS, a, stream);
#endif
  }
  return -1;
}

template <bool F32>
int launch_pools(const PrefillArgs& a, int BS, int hd, cudaStream_t s) {
  const bool int8_pool = a.k_scale != nullptr;
  if (int8_pool != (a.v_scale != nullptr)) return -1;
  return int8_pool ? launch_hd<true, F32>(hd, BS, a, s)
                   : launch_hd<false, F32>(hd, BS, a, s);
}

}  // namespace

// C entry point, bound with ctypes. q and out are bf16, 16-byte aligned
// (q rows are copied in 16-byte pieces). k_scale/v_scale
// null: the pools are bf16; both set: the pools are int8 with [Hkv, NB]
// f32 scales. Returns the cudaError_t of the launch (0 = launched), or -1
// for a head_dim (64, 128; 96 and 256 in the RAGGED_PREFILL_HD96 and
// RAGGED_PREFILL_HD256 libraries) /
// block size this library was not built for.
extern "C" int b2b_ragged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offset, void* out, int B, int T_, int H, int Hkv, int NB,
    int MB, int BS, int hd, int window, float sm_scale, float softcap,
    void* stream) {
  const PrefillArgs a{q, k_pool, v_pool,
                      static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale),
                      static_cast<const int*>(tables),
                      static_cast<const int*>(offset), out,
                      B, T_, H, Hkv, NB, MB, window, sm_scale, softcap};
  return launch_pools<false>(a, BS, hd, static_cast<cudaStream_t>(stream));
}

// C entry point of the f32 form, the same arguments with q and out f32,
// 16-byte aligned, and the pools f32 or int8 with scales.
extern "C" int b2b_ragged_prefill_attention_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offset, void* out, int B, int T_, int H, int Hkv, int NB,
    int MB, int BS, int hd, int window, float sm_scale, float softcap,
    void* stream) {
  const PrefillArgs a{q, k_pool, v_pool,
                      static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale),
                      static_cast<const int*>(tables),
                      static_cast<const int*>(offset), out,
                      B, T_, H, Hkv, NB, MB, window, sm_scale, softcap};
  return launch_pools<true>(a, BS, hd, static_cast<cudaStream_t>(stream));
}
