// Flash attention over contiguous K/V for Hopper (sm_90a): tiled causal or
// non-causal GQA attention of q [B, T, H, HD] over k, v [B, S, Hkv, HD].
//
// Replaces the TPU kernel bee2bee_tpu/ops/flash.py:_flash_kernel. Same
// function: per-row offset (query t of row b sits at offset[b] + t), GQA
// head h reads kv head h / (H / Hkv), key tiles above the diagonal are
// skipped (here through the loop bound), a row that sees nothing (offset
// -1 at T = 1) writes 0. The JAX wrapper transposes K/V to head-major and
// zero-pads S to the block; these kernels read [B, S, Hkv, HD] in place (a
// key row of one head is HD contiguous elements, so 16-byte loads still
// work) and treat keys past S as absent. Inside the contract
// offset + T <= S the two agree; past it the JAX kernel attends the
// padding's zeros.
//
// Three kernels, chosen by ops/flash.py:flash_kernel:
//
// flash_tile_kernel, for bf16 at HD 64, 96, 128 and 256: the tensor-core tile
// design of tile_attention.cuh (the ragged prefill kernel's, over
// contiguous K/V; at HD 256 its resident-Q form with 32-key tiles). What bounds it on an H100: causal T = S = 2048 over
// llama-3-8b's heads does 4 * HD flops per visible (query, key) pair per
// head, 3.4e10 flops, 0.0348 ms at 989 TFLOP/s bf16, against 0.010 ms to
// read q, k, v and write the output once: bound by operations. So both
// products run on mma.sync with f32 accumulation (P rounded to bf16
// before P V, as the JAX kernel's p.astype(v.dtype)):
//   grid  (B * Hkv, ceil(G * T / 64)); a block of 4 warps owns 64 query
//         rows of one (batch row, kv head), rows folded (t major, g
//         minor) so each staged key tile serves the whole GQA group; the
//         blocks with the latest (longest) rows start first;
//   stage key tiles of 64 rows of K and V, read in place (Hkv * HD
//         elements apart) with 16-byte cp.async copies, double-buffered;
//         when causal, no tile past the frontier of the block's last row;
//         rows past S are zero-filled and masked;
//   HD 256 gemma-2-9b's 16 heads of 256 do the flops of llama-3-8b's 32
//         of 128, but Q's fragments, the accumulator and S would need
//         about 224 registers a lane: Q
//         [64][256] stays resident in shared memory (32 KB) and is read a
//         k-step at a time, and key tiles hold 32 keys, so two blocks of
//         96 KB share an SM and a lane spills nothing.
//
// flash_tile_f32_kernel, for f32 at HD 64, 96, 128 and 256: the same grid, row
// fold and causal frontier over 32-key f32 tiles, with both products in
// 3xTF32 on mma.sync m16n8k8 (tile_attention_f32.cuh). Its bound on an
// H100 is the three TF32 products: 3 * 4 * HD flops per visible pair at
// 494.7 TFLOP/s, 0.2085 ms at causal T = S = 2048 (one f32 product on the
// CUDA cores, at 67 TFLOP/s, would take 0.5131 ms), against 0.025 ms of
// bytes: bound by operations.
//
// flash_attention_kernel, which the dispatch no longer names (it stays,
// built at HD 64, 96, 128 and 256, to time the tile kernels against): the
// ragged row kernel's row-per-warp design (ragged_attention.cu) with another way to
// address keys:
//   grid  (B * Hkv, ceil(G * T / kWarps)); a block owns kWarps query rows
//         of one (batch row, kv head), one warp per row;
//   loop  over the block's key tiles of kTile keys: keys j*kTile ..
//         j*kTile + kTile - 1 of row b, Hkv*HD elements apart, staged in
//         shared memory with 16-byte loads; when causal, no tile past the
//         causal frontier of the block's last row;
//   score each warp computes its row's kTile scores with the lanes split
//         over HD and a shuffle reduction;
//   softmax online, in f32, with the accumulator in registers;
//   out   written straight into [B, T, H * HD].
// It does scalar dot products on the CUDA cores, at long T each block
// walks up to S / kTile tiles for only kWarps rows.

#include <type_traits>

#include "attention.cuh"
#include "tile_attention.cuh"
#include "tile_attention_f32.cuh"

namespace {

constexpr int kTile = 32;  // keys per shared-memory tile

struct FlashArgs {
  const void* q;       // [B, T, H, HD]
  const void* k;       // [B, S, Hkv, HD]
  const void* v;
  const int* offset;   // [B]: position of q[b, 0]
  void* out;           // [B, T, H * HD]
  int B, T, S, H, Hkv, causal;
  float sm_scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q,       // [B, T, H, HD]
                       const T* __restrict__ k,       // [B, S, Hkv, HD]
                       const T* __restrict__ v,       // [B, S, Hkv, HD]
                       const int* __restrict__ offset,  // [B]
                       T* __restrict__ out,           // [B, T, H * HD]
                       int T_, int S, int H, int Hkv, int causal,
                       float sm_scale) {
  constexpr int BS = kTile;
  constexpr int E = HD / 32;           // elements of a row per lane
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int RV = HD / VEC;         // 16-byte loads per key row
  static_assert(HD % 32 == 0, "HD must be a multiple of 32");
  static_assert(HD % VEC == 0, "a key row must be whole 16-byte vectors");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BS * HD;

  const int G = H / Hkv;
  const int nrows = G * T_;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kWarps;
  const int row = row0 + warp;
  const bool live = row < nrows;
  const int off = offset[b];

  // the tile walk: when causal, no tile past the frontier of the block's
  // last row (above the diagonal); rows are g-major, t-minor
  const int last = min(row0 + kWarps, nrows) - 1;
  const int thi = row0 / T_ == last / T_ ? last % T_ : T_ - 1;
  int jhi = (S + BS - 1) / BS - 1;
  if (causal) jhi = min(floor_div(off + thi, BS), jhi);

  const int g = live ? row / T_ : 0;
  const int t = live ? row % T_ : 0;
  const int h = kvh * G + g;
  const int qpos = off + t;

  float qf[E];
  float acc[E];
  const T* qr = q + ((size_t)(b * T_ + t) * H + h) * HD + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qf[e] = live ? to_float(qr[e]) * sm_scale : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const size_t stride = (size_t)Hkv * HD;
  for (int j = 0; j <= jhi; ++j) {
    // keys j*BS .. j*BS + BS - 1 of row b; rows past S are not read
    // (those keys are masked)
    const size_t base = (((size_t)b * S + (size_t)j * BS) * Hkv + kvh) * HD;
    const int nvalid = min(BS, S - j * BS);
    for (int i = threadIdx.x; i < BS * RV; i += kWarps * 32) {
      const int c = i / RV;
      const int w = i % RV;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = kx;
      if (c < nvalid) {
        kx = reinterpret_cast<const uint4*>(k + base + c * stride)[w];
        vx = reinterpret_cast<const uint4*>(v + base + c * stride)[w];
      }
      reinterpret_cast<uint4*>(ks)[i] = kx;
      reinterpret_cast<uint4*>(vs)[i] = vx;
    }
    __syncthreads();
    if (live) {
      const int kv0 = j * BS;
      float s[BS];
      float mtile = -INFINITY;
#pragma unroll
      for (int c = 0; c < BS; ++c) {
        const T* kr = ks + c * HD + lane * E;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qf[e] * to_float(kr[e]);
        // xor butterfly: every lane ends with the same full sum
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        const int kvpos = kv0 + c;
        const bool vis = kvpos < S && (!causal || kvpos <= qpos);
        s[c] = vis ? d : -INFINITY;
        mtile = fmaxf(mtile, s[c]);
      }
      if (mtile > -INFINITY) {
        const float mnew = fmaxf(m, mtile);
        const float alpha = expf(m - mnew);  // 0 on the first visible tile
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
        for (int c = 0; c < BS; ++c) {
          if (s[c] == -INFINITY) continue;
          const float p = expf(s[c] - mnew);
          psum += p;
          const T* vr = vs + c * HD + lane * E;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += p * to_float(vr[e]);
        }
        l = l * alpha + psum;
        m = mnew;
      }
    }
    __syncthreads();
  }

  if (live) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // nothing visible -> 0
    T* o = out + ((size_t)(b * T_ + t) * H + h) * HD + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = from_float<T>(acc[e] * inv);
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const int tiles = (a.H / a.Hkv * a.T + kWarps - 1) / kWarps;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.B * a.Hkv, tiles);
  const size_t smem = 2 * (size_t)kTile * HD * sizeof(T);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.offset, static_cast<T*>(a.out), a.T, a.S,
      a.H, a.Hkv, a.causal, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const FlashArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(a, stream);
    case 96:
      return launch<T, 96>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    case 256:
      return launch<T, 256>(a, stream);
  }
  return -1;
}

// ------------------------------------------------------------ tile kernel

using tile::bf16;

// Stage key tile j (keys j * KEYS ..) of row b, kv head kvh into ks/vs
// (swizzled); keys past kmax are not read and their slots zero-filled.
template <int HD, int KEYS>
__device__ __forceinline__ void stage_keys(const bf16* k, const bf16* v, int b,
                                           int kvh, int S, int Hkv, int kmax,
                                           int j, uint4* ks, uint4* vs) {
  constexpr int RC = HD / 8;
  for (int id = threadIdx.x; id < KEYS * RC; id += tile::kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int key = j * KEYS + r;
    size_t src = 0;
    if (key <= kmax) src = (((size_t)b * S + key) * Hkv + kvh) * HD + c * 8;
    const int n = key <= kmax ? 16 : 0;
    tile::cp_async16(ks + tile::swz<HD>(r, c), k + src, n);
    tile::cp_async16(vs + tile::swz<HD>(r, c), v + src, n);
  }
}

// (the minimum of one block an SM lets ptxas past the 168 registers it
// otherwise holds the head_dim-96 form to, where it spilled 16 bytes)
template <int HD>
__global__ void __launch_bounds__(tile::kThreads, 1)
flash_tile_kernel(const FlashArgs a) {
  constexpr bool QS = tile::q_resident<HD>();  // Q stays in shared memory
  constexpr int KEYS = tile::tile_keys<HD>();
  constexpr int TILE = KEYS * HD / 8;  // uint4 chunks of a K/V tile
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][K, V], after the resident Q tile at HD 256
  uint4* kv = reinterpret_cast<uint4*>(smem) + (QS ? tile::kRows * HD / 8 : 0);
  // otherwise Q passes through the second stage's K tile: every warp has
  // read it into registers before the first copy into that stage
  static_assert(tile::kRows == tile::kKeys, "Q is staged in a K tile");
  uint4* qs = QS ? reinterpret_cast<uint4*>(smem) : kv + 2 * TILE;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int nrows = G * a.T;
  // the longest rows first: tile y of the grid is row tile gridDim.y-1-y
  const int r0 = (gridDim.y - 1 - blockIdx.y) * tile::kRows;
  const int off = a.offset[b];
  const int thi = (min(r0 + tile::kRows, nrows) - 1) / G;
  // keys the block's rows see: all of [0, S) without causality, else up
  // to the frontier of its last row
  const int kmax = a.causal ? min(off + thi, a.S - 1) : a.S - 1;
  const int jhi = kmax >= 0 ? kmax / KEYS : -1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  tile::stage_q<HD>(qs, static_cast<const bf16*>(a.q), b, kvh, a.T, a.H, G, r0,
                    nrows);
  if (jhi >= 0)
    stage_keys<HD, KEYS>(k, v, b, kvh, a.S, a.Hkv, kmax, 0, kv, kv + TILE);
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
  int rmin[2], rmax[2];
  bf16* dst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = r0 + warp * 16 + (lane >> 2) + 8 * i;
    rmin[i] = 0;
    rmax[i] = -1;
    dst[i] = nullptr;
    if (R < nrows) {
      const int t = R / G;
      rmax[i] = a.causal ? min(off + t, a.S - 1) : a.S - 1;
      dst[i] = static_cast<bf16*>(a.out) +
               ((size_t)(b * a.T + t) * a.H + kvh * G + R % G) * HD;
    }
  }
  const tile::RowSpan sp = tile::warp_span(rmin, rmax);

  for (int j = 0; j <= jhi; ++j) {
    const int st = j & 1;
    // tile j has landed; every warp is done with tile j - 1
    tile::cp_async_wait_all();
    __syncthreads();
    if (j < jhi)
      stage_keys<HD, KEYS>(k, v, b, kvh, a.S, a.Hkv, kmax, j + 1,
                           kv + (st ^ 1) * 2 * TILE,
                           kv + (st ^ 1) * 2 * TILE + TILE);
    tile::cp_async_commit();
    int lo[2], hi[2];
    const unsigned live = tile::tile_ranges<KEYS>(sp, j * KEYS, lo, hi);
    const uint4* ks = kv + st * 2 * TILE;
    if constexpr (QS)
      tile::attend_tile<HD>(w, qw, ks, ks + TILE, live, lo, hi, a.sm_scale, 0.f,
                            lane);
    else
      tile::attend_tile<HD>(w, ks, ks + TILE, live, lo, hi, a.sm_scale, 0.f, lane);
  }
  tile::store_rows<HD>(w, dst, lane);
}

// ------------------------------------------------------- f32 tile kernel

// Stage f32 key tile j (keys j * kKeys ..) of row b, kv head kvh into the
// padded K and V tiles; keys past kmax are not read and their slots
// zero-filled.
template <int HD>
__device__ __forceinline__ void stage_keys_f32(const float* k, const float* v,
                                               int b, int kvh, int S, int Hkv,
                                               int kmax, int j, float* ks,
                                               float* vs) {
  constexpr int RC = HD / 4;  // 16-byte chunks per row
  for (int id = threadIdx.x; id < tile32::kKeys * RC; id += tile32::kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int key = j * tile32::kKeys + r;
    size_t src = 0;
    if (key <= kmax) src = (((size_t)b * S + key) * Hkv + kvh) * HD + c * 4;
    const int n = key <= kmax ? 16 : 0;
    tile::cp_async16(ks + r * tile32::qk_stride<HD>() + c * 4, k + src, n);
    tile::cp_async16(vs + r * tile32::v_stride<HD>() + c * 4, v + src, n);
  }
}

// The f32 tile kernel: flash_tile_kernel's geometry and causal frontier in
// f32, with tile_attention_f32.cuh's 3xTF32 products and 32-key tiles.
template <int HD>
__global__ void __launch_bounds__(tile32::kThreads)
flash_tile_f32_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAIR = tile32::k_tile<HD>() + tile32::v_tile<HD>();
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][HD + 8]
  float* kv = qs + tile32::q_tile<HD>();       // [stage][K, V]
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int nrows = G * a.T;
  // the longest rows first: tile y of the grid is row tile gridDim.y-1-y
  const int r0 = (gridDim.y - 1 - blockIdx.y) * tile32::kRows;
  const int off = a.offset[b];
  const int thi = (min(r0 + tile32::kRows, nrows) - 1) / G;
  const int kmax = a.causal ? min(off + thi, a.S - 1) : a.S - 1;
  const int jhi = kmax >= 0 ? kmax / tile32::kKeys : -1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // key tile j into its stage (j & 1)
  auto stage = [&](int j) {
    float* ks = kv + (j & 1) * PAIR;
    stage_keys_f32<HD>(k, v, b, kvh, a.S, a.Hkv, kmax, j, ks,
                       ks + tile32::k_tile<HD>());
  };

  tile32::stage_q<HD>(qs, static_cast<const float*>(a.q), b, kvh, a.T, a.H, G,
                      r0, nrows);
  if (jhi >= 0) stage(0);
  tile::cp_async_commit();

  tile32::WarpRows<HD> w;
  tile32::init_rows<HD>(w);
  // rows that fit one warp: every warp takes them, each with its own
  // quarter of the keys
  const bool ksplit = nrows - r0 <= 16;
  const int row0 = ksplit ? 0 : warp * 16;
  int rmin[2], rmax[2];
  float* dst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int R = r0 + row0 + (lane >> 2) + 8 * i;
    rmin[i] = 0;
    rmax[i] = -1;
    dst[i] = nullptr;
    if (R < nrows) {
      const int t = R / G;
      rmax[i] = a.causal ? min(off + t, a.S - 1) : a.S - 1;
      if (!ksplit || warp == 0)
        dst[i] = static_cast<float*>(a.out) +
                 ((size_t)(b * a.T + t) * a.H + kvh * G + R % G) * HD;
    }
  }
  const tile::RowSpan sp = tile::warp_span(rmin, rmax);

  for (int j = 0; j <= jhi; ++j) {
    // tile j (and Q) has landed; every warp is done with tile j - 1, whose
    // stage takes tile j + 1
    tile::cp_async_wait_all();
    __syncthreads();
    if (j < jhi) stage(j + 1);
    tile::cp_async_commit();
    int lo[2], hi[2];
    unsigned live = tile32::tile_ranges(sp, j * tile32::kKeys, lo, hi);
    if (ksplit) live &= 1u << warp;
    const float* ks = kv + (j & 1) * PAIR;
    tile32::attend_tile<HD>(w, qs, ks, ks + tile32::k_tile<HD>(), live, lo, hi,
                            a.sm_scale, 0.f, row0, lane);
  }
  tile::cp_async_wait_all();  // no copy in flight (jhi < 0: Q's)
  if (ksplit) {
    static_assert(tile32::merge_floats<HD>() <= tile32::q_tile<HD>(),
                  "the merge fits in the Q tile");
    __syncthreads();  // every warp is done with Q and the last tile
    tile32::merge_warps<HD>(w, qs, warp, lane);
  }
  tile32::store_rows<HD>(w, dst, lane);
}

// The launch of either tile kernel (F32: the f32 one); both take 64 query
// rows a block.
template <int HD, bool F32>
int launch_tile(const FlashArgs& a, cudaStream_t stream) {
  static_assert(tile::kRows == tile32::kRows, "one grid for both forms");
  const int tiles = (a.H / a.Hkv * a.T + tile::kRows - 1) / tile::kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.B * a.Hkv, tiles);
  // bf16: two stages of K and V tiles (after a resident Q at HD 256); f32:
  // Q, then two stages of K and V
  constexpr size_t smem =
      F32 ? (size_t)4 * (tile32::q_tile<HD>() +
                         2 * (tile32::k_tile<HD>() + tile32::v_tile<HD>()))
          : (tile::q_resident<HD>() ? (size_t)tile::kRows * HD * 2 : 0) +
                (size_t)4 * tile::tile_keys<HD>() * HD * 2;
  auto kernel = F32 ? flash_tile_f32_kernel<HD> : flash_tile_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, tile32::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the row kernel, bound with ctypes. dtype: 0 = float32,
// 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = launched), or -1 for a dtype
// or head_dim this file was not built for.
extern "C" int b2b_flash_attention(const void* q, const void* k,
                                   const void* v, const void* offset,
                                   void* out, int B, int T_, int S, int H,
                                   int Hkv, int hd, int causal,
                                   float sm_scale, int dtype, void* stream) {
  const FlashArgs a{q, k, v, static_cast<const int*>(offset), out,
                    B, T_, S, H, Hkv, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, a, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(hd, a, s);
  return -1;
}

// C entry point of the tile kernel, bound with ctypes: q, k, v and out are
// bf16, 16-byte aligned. Returns the cudaError_t of the launch (0 =
// launched), or -1 for a head_dim (64, 96, 128, 256) this kernel was not built
// for.
extern "C" int b2b_flash_attention_tile(const void* q, const void* k,
                                        const void* v, const void* offset,
                                        void* out, int B, int T_, int S, int H,
                                        int Hkv, int hd, int causal,
                                        float sm_scale, void* stream) {
  const FlashArgs a{q, k, v, static_cast<const int*>(offset), out,
                    B, T_, S, H, Hkv, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_tile<64, false>(a, s);
  if (hd == 96) return launch_tile<96, false>(a, s);
  if (hd == 128) return launch_tile<128, false>(a, s);
  if (hd == 256) return launch_tile<256, false>(a, s);
  return -1;
}

// C entry point of the f32 tile kernel, bound with ctypes: q, k, v and out
// are f32, 16-byte aligned. Returns the cudaError_t of the launch (0 =
// launched), or -1 for a head_dim this kernel was not built for.
extern "C" int b2b_flash_attention_tile_f32(const void* q, const void* k,
                                            const void* v, const void* offset,
                                            void* out, int B, int T_, int S,
                                            int H, int Hkv, int hd, int causal,
                                            float sm_scale, void* stream) {
  const FlashArgs a{q, k, v, static_cast<const int*>(offset), out,
                    B, T_, S, H, Hkv, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_tile<64, true>(a, s);
  if (hd == 96) return launch_tile<96, true>(a, s);
  if (hd == 128) return launch_tile<128, true>(a, s);
  if (hd == 256) return launch_tile<256, true>(a, s);
  return -1;
}
