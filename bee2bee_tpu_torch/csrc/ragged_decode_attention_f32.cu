// Ragged paged attention of f32 decode steps and short f32 chunks for
// Hopper (sm_90a), split-K ("flash-decoding") on the CUDA cores: the G * T
// query rows of one (batch row, kv head) attend to the row's pages of the
// paged KV pool through its block table.
//
// Replaces the TPU kernel bee2bee_tpu/ops/ragged.py:_ragged_kernel for f32
// queries (q.dtype == float32) at head_dim 64, 96, 128 and 256 whose G * T rows
// fit one block (at most kMaxRows) and whose chunk is shorter than the f32
// tile form's crossover (ops/ragged.py:use_decode_f32_kernel), in both pool
// forms: the f32 pool, and the int8 pool whose pages carry one f32 scale
// per (kv head, block), read beside tables[b, j]. Same function: rows
// folded g-major, t-minor (row r = g * T + t sits at offset[b] + t); one
// sliding `window` per call (0 = full causal), `sm_scale`, tanh `softcap`
// applied before the mask; a masked key is never read from the pool (its
// slot in shared memory is zero-filled), so the null block's garbage cannot
// reach a row; a row that sees nothing writes 0. P stays in f32, as the
// JAX kernel's p.astype(v.dtype) is the identity for f32 values. An int8
// page's scale multiplies its keys' scores and its values' probabilities
// rather than each element: the same products in f32, in another order.
//
// What bounds it on an H100: the bytes of the visible K/V pages. Decode at
// llama-3-8b's heads, B = 8 over a 1024-token context, reads 67 MB of f32
// pages (0.0201 ms at 3.35 TB/s; gemma-2-9b's hd 256: 134 MB, 0.0401 ms)
// or a quarter of that from an int8 pool, and does 4 * HD flops per key
// and query head: 134 MFLOP, about 2 us at the 67 TFLOP/s of f32 FFMA. So
// it computes in plain IEEE f32 on the CUDA cores (no TF32, no tensor
// cores), and its design aims at bytes in flight:
//   split the page walk of each (batch row, kv head) over `splits` blocks
//         of `split_pages` pages (ops/ragged.py:decode_f32_splits, from
//         host shapes only, so a captured decode graph keeps its plan); a
//         split wholly past its row's frontier or below its window writes
//         an empty partial (l = 0) and exits;
//   stage tiles of 32 keys with 16-byte cp.async copies into a short ring
//         (2-4 stages), so that several blocks share an SM and their
//         per-tile steps overlap: f32 hd 128 2 stages of 33 KB, three
//         blocks an SM; hd 256 2 of 65 KB, one block; int8 hd 128 4 of 9
//         KB, five blocks (decode_f32_probe.py: deeper rings with fewer
//         blocks an SM were as fast or slower at every timed shape but
//         gemma-2-9b's heads at B = 1 in f32);
//   hold Q's G * T rows in shared memory, one block per (row, kv head,
//         split), so each key is read from device memory once;
//   Q K^T: a lane owns a key, the 4 warps split the head dimension; a lane
//         reads its key's row as float4s over a row stride padded by 16
//         bytes, so the 8 lanes of a quarter-warp hit distinct banks, and Q
//         by broadcast; an int8 key is converted once a block (byte_perm
//         and one add a value, no I2F); the warps' partial dots meet in
//         shared memory, added in warp order;
//   softmax: online in f32 per row (each warp owns every 4th row), P and
//         the rescale factor of each row in shared memory;
//   P V: lanes own columns; with up to 8 rows the warps split the tile's
//         keys and hold all rows (8 x HD / 32 accumulators a lane), with
//         up to 32 rows they split the rows (8 a warp); so the accumulator
//         is 64 registers a lane at HD 256 and no form spills;
//   merge the block's key groups in warp order, write its f32 partial
//         (m, l, acc) to scratch that the wrapper allocates, and let a
//         second kernel merge the splits of each row in a fixed order, with
//         no atomics: results repeat bit for bit.
// At HD 96 (phi-3's heads) a warp's 24 dims of an int8 key are three
// 8-byte pieces (a 16-byte load would start off its alignment in every
// odd warp; across a half-warp the 8-byte loads over the 112-byte padded
// rows meet 2-way bank conflicts), a lane's three P V columns two
// adjacent and one lane-strided (lane_col), and the merge kernel's 24-lane
// row groups leave 8 of its 128 threads idle; the rings are those of HD
// 128.
// One C entry point launches both kernels. Instantiated for HD 64, 96, 128
// and 256, both pool forms and two row capacities (8, 32); the block size
// (8, 16, 32) is a run-time shift.

#include "tile_attention.cuh"

namespace {

using tile::cp_async16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;         // keys per staged tile: one a lane in Q K^T
constexpr int kMaxRows = 32;      // G * T query rows a block holds
constexpr int kWarpRows = 8;      // rows of P V accumulators a warp holds
constexpr int kMaxSplitPages = 64;  // the split's table entries in smem

struct DecodeF32Args {
  const float* q;        // [B, T, H, HD]
  const void* k_pool;    // [Hkv, NB, BS, HD] f32, or int8 with scales
  const void* v_pool;
  const float* k_scale;  // [Hkv, NB] scales of an int8 pool, else nullptr
  const float* v_scale;
  const int* tables;     // [B, MB]
  const int* offset;     // [B]: position of q[b, 0]
  float* out;            // [B, T, H * HD]
  float* part;           // scratch: acc [.., HD] then (m, l), per (b, kvh, split, row)
  int B, T, H, Hkv, NB, MB, bs_shift, window, splits, split_pages;
  float sm_scale, softcap;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the merge kernel may start launching once every block of the split walk
// has written its partial (programmatic dependent launch)
__device__ __forceinline__ void let_merge_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// bytes of one pool row, and of one staged key row: the pool row plus 16
// bytes of padding, so that lanes reading different keys at one column
// hit different banks (a value row is read whole by one warp: unpadded)
template <int HD, bool INT8>
__host__ __device__ constexpr int pool_row_bytes() {
  return INT8 ? HD : HD * 4;
}
template <int HD, bool INT8>
__host__ __device__ constexpr int row_bytes() {
  return pool_row_bytes<HD, INT8>() + 16;
}

// ring stages per form (see the design note above)
template <int HD, bool INT8, int RMAX>
__host__ __device__ constexpr int stages() {
  if (INT8) return HD == 256 ? (RMAX == 8 ? 3 : 2) : 4;
  return HD == 64 ? 3 : 2;
}

// shared memory: the ring [stage] of K [kKeys][row_bytes] and V
// [kKeys][pool_row_bytes], then Q
// [RMAX][HD], the warps' partial scores [kWarps][RMAX][kKeys], P
// [RMAX][kKeys] and each row's rescale factor [RMAX] (f32); then, sized at
// launch, the split's table entries [split_pages] and, for an int8 pool,
// its pages' scales [K, V][split_pages]. After the walk the ring holds the
// warps' accumulators for the merge of the key groups.
template <int HD, bool INT8, int RMAX>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)stages<HD, INT8, RMAX>() * kKeys *
         (row_bytes<HD, INT8>() + pool_row_bytes<HD, INT8>());
}
template <int HD, bool INT8, int RMAX>
__host__ __device__ constexpr size_t fixed_smem_bytes() {
  return ring_bytes<HD, INT8, RMAX>() +
         (size_t)RMAX * (HD + kWarps * kKeys + kKeys + 1) * sizeof(float);
}
template <bool INT8>
size_t split_smem_bytes(int split_pages) {
  return (size_t)split_pages * (INT8 ? 3 : 1) * 4;
}

// 4 int8 values (one 32-bit word) as f32, exactly: each byte b + 128 is
// put under the exponent of 2^23, and 2^23 + 128 taken off
__device__ __forceinline__ void int8x4_to_float(uint32_t x, float* f) {
  const uint32_t u = x ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// Column c (< HD / 32) of the lane's P V columns: HD 64 two adjacent, HD
// 128 four adjacent, HD 256 four at 4 * lane and four at 128 + 4 * lane,
// so a warp reads each value row in 16-byte pieces without conflicts; HD
// 96 two adjacent at 2 * lane and one at 64 + lane (an 8-byte and a
// 4-byte piece, each a warp's contiguous 256 or 128 bytes)
template <int HD>
__device__ __forceinline__ int lane_col(int lane, int c) {
  if (HD == 64) return 2 * lane + c;
  if (HD == 96) return c < 2 ? 2 * lane + c : 64 + lane;
  if (HD == 128) return 4 * lane + c;
  return (c < 4 ? 4 * lane : 128 + 4 * lane) + (c & 3);
}

// one int8 value (the low byte of x) as f32, exactly, as int8x4_to_float
__device__ __forceinline__ float int8_to_float(uint32_t x) {
  return __uint_as_float(0x4B000000u | ((x ^ 0x80u) & 0xffu)) - 8388736.f;
}

// the lane's HD / 32 columns of one staged value row, as f32
template <int HD, bool INT8>
__device__ __forceinline__ void load_v(const unsigned char* row, int lane,
                                       float (&v)[HD / 32]) {
  if constexpr (INT8) {
    if constexpr (HD == 64 || HD == 96) {
      const uint32_t x = *reinterpret_cast<const unsigned short*>(row + 2 * lane);
      float f[4];
      int8x4_to_float(x, f);
      v[0] = f[0];
      v[1] = f[1];
      if constexpr (HD == 96) v[2] = int8_to_float(row[64 + lane]);
    } else {
#pragma unroll
      for (int h = 0; h < HD / 128; ++h)
        int8x4_to_float(*reinterpret_cast<const uint32_t*>(row + 128 * h + 4 * lane),
                        v + 4 * h);
    }
  } else {
    const float* r = reinterpret_cast<const float*>(row);
    if constexpr (HD == 64 || HD == 96) {
      const float2 x = *reinterpret_cast<const float2*>(r + 2 * lane);
      v[0] = x.x;
      v[1] = x.y;
      if constexpr (HD == 96) v[2] = r[64 + lane];
    } else {
#pragma unroll
      for (int h = 0; h < HD / 128; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(r + 128 * h + 4 * lane);
        v[4 * h] = x.x;
        v[4 * h + 1] = x.y;
        v[4 * h + 2] = x.z;
        v[4 * h + 3] = x.w;
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, bool INT8, int RMAX>
__global__ void __launch_bounds__(kThreads)
ragged_decode_f32_kernel(const DecodeF32Args a) {
  constexpr int S = stages<HD, INT8, RMAX>();
  constexpr int ROWB = row_bytes<HD, INT8>();        // a staged key row
  constexpr int VROWB = pool_row_bytes<HD, INT8>();  // a staged value row
  constexpr int STAGEB = kKeys * (ROWB + VROWB);     // bytes of a stage
  constexpr int CH = VROWB / 16;                     // 16-byte chunks of a row
  constexpr int WR = RMAX / kWarpRows;  // P V: row groups (1 or 4)
  constexpr int WK = kWarps / WR;       // P V: key groups (4 or 1)
  constexpr int KPW = kKeys / WK;       // P V: keys a warp takes of a tile
  constexpr int DQ = HD / kWarps;       // Q K^T: dims a warp takes
  constexpr int RPS = RMAX / kWarps;    // softmax: rows a warp owns
  constexpr int CPL = HD / 32;          // P V: columns a lane owns
  // P V's key loop unrolled twice; at HD 96 over an int8 pool with 8 rows
  // ptxas holds the kernel at 96 registers and spilled 4 bytes so: rolled,
  // it fits them
  constexpr int PV_UNROLL = HD == 96 && INT8 && RMAX == kWarpRows ? 1 : 2;
  static_assert(RMAX == 8 || RMAX == 32, "row capacities: 8 and 32");
  static_assert(WK == 1 || (size_t)kWarps * RMAX * HD * 4 <= ring_bytes<HD, INT8, RMAX>(),
                "the key groups' accumulators must fit the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<HD, INT8, RMAX>());
  float* sp = qs + RMAX * HD;             // [kWarps][RMAX][kKeys]
  float* ps = sp + kWarps * RMAX * kKeys;  // [RMAX][kKeys]
  float* as = ps + RMAX * kKeys;           // [RMAX]
  int* blocks = reinterpret_cast<int*>(as + RMAX);
  float* ksc = reinterpret_cast<float*>(blocks + a.split_pages);
  float* vsc = ksc + a.split_pages;

  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // b * Hkv + kvh
  const int b = bk / a.Hkv;
  const int kvh = bk % a.Hkv;
  const int G = a.H / a.Hkv;
  const int R = G * a.T;
  const int BS = 1 << a.bs_shift;
  // the split's table entries, read while the offset is
  const int* row_table = a.tables + (size_t)b * a.MB;
  for (int i = threadIdx.x; i < a.split_pages; i += kThreads) {
    const int page = split * a.split_pages + i;
    blocks[i] = page < a.MB ? row_table[page] : 0;
  }
  // the keys the block reads: [kmin, kmax], its rows' visible keys inside
  // the split (the first row's window, the last row's frontier)
  const int off = a.offset[b];
  const int p0 = split * a.split_pages;
  const int kmax = min(off + a.T - 1, min(p0 + a.split_pages, a.MB) * BS - 1);
  const int kmin = max(a.window > 0 ? off - a.window + 1 : 0, p0 * BS);
  const size_t slot0 = ((size_t)bk * a.splits + split) * R;
  float* acc_out = a.part + slot0 * HD;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.splits * R * HD + 2 * slot0;

  if (kmin > kmax) {  // the split lies past the frontier or below the window
    for (int r = threadIdx.x; r < R; r += kThreads) {
      ml[2 * r] = -INFINITY;
      ml[2 * r + 1] = 0.f;
    }
    let_merge_launch();
    return;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = kmin / kKeys;
  const int t1 = kmax / kKeys;
  const unsigned char* kpool = static_cast<const unsigned char*>(a.k_pool);
  const unsigned char* vpool = static_cast<const unsigned char*>(a.v_pool);

  // stage the tile of keys [t * kKeys, + kKeys): a key outside the block's
  // span is not read and its slots are zero-filled
  auto load_tile = [&](int t, int st) {
    if (t > t1) return;
    unsigned char* ks = ring + (size_t)st * STAGEB;
    unsigned char* vs = ks + kKeys * ROWB;
    for (int id = threadIdx.x; id < kKeys * CH; id += kThreads) {
      const int r = id / CH;
      const int c = id % CH;
      const int key = t * kKeys + r;
      const bool vis = key >= kmin && key <= kmax;
      size_t src = 0;
      if (vis) {
        const int blk = blocks[(key >> a.bs_shift) - p0];
        src = (((size_t)kvh * a.NB + blk) * BS + (key & (BS - 1))) * VROWB + c * 16;
      }
      cp_async16(ks + r * ROWB + c * 16, kpool + src, vis ? 16 : 0);
      cp_async16(vs + r * VROWB + c * 16, vpool + src, vis ? 16 : 0);
    }
  };

  // Q: row r = g * T + t is query head kvh * G + g at chunk position t;
  // rows past R are zero
  for (int id = threadIdx.x; id < RMAX * (HD / 4); id += kThreads) {
    const int r = id / (HD / 4);
    const int c = id % (HD / 4);
    const float* src = a.q;
    if (r < R)
      src = a.q + (((size_t)b * a.T + r % a.T) * a.H + kvh * G + r / a.T) * HD + c * 4;
    cp_async16(qs + r * HD + c * 4, src, r < R ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    load_tile(t0 + i, i);
    tile::cp_async_commit();
  }
  if constexpr (INT8) {
    // the pages' scales, while the first tiles are in flight; 0 for a
    // page the block does not read
    for (int i = threadIdx.x; i < a.split_pages; i += kThreads) {
      const int first = (p0 + i) * BS;
      const bool vis = first <= kmax && first + BS - 1 >= kmin;
      ksc[i] = vis ? a.k_scale[(size_t)kvh * a.NB + blocks[i]] : 0.f;
      vsc[i] = vis ? a.v_scale[(size_t)kvh * a.NB + blocks[i]] : 0.f;
    }
  }

  float m[RPS], l[RPS];
#pragma unroll
  for (int i = 0; i < RPS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[kWarpRows][CPL];
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[j][c] = 0.f;
  const int rg = warp / WK;  // P V: the warp's rows rg * 8 .. + 7
  const int kg = warp % WK;  //       and its keys kg * KPW .. + KPW - 1

  for (int t = t0, i = 0; t <= t1; ++t, ++i) {
    // tile t (and Q) has landed; every warp is done with the stage it
    // replaces and with the last tile's P
    cp_async_wait<S - 2>();
    __syncthreads();
    load_tile(t + S - 1, (i + S - 1) % S);
    tile::cp_async_commit();
    const unsigned char* ks = ring + (size_t)(i % S) * STAGEB;
    const unsigned char* vs = ks + kKeys * ROWB;

    // Q K^T: the lane's key against every row, over the warp's dims
    {
      float s[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) s[r] = 0.f;
      const unsigned char* krow = ks + lane * ROWB;
      if constexpr (INT8) {
        // the warp's DQ bytes of the key in 16-byte pieces, or at HD 96
        // (DQ 24, every odd warp's start 8 bytes off a 16-byte boundary)
        // in 8-byte ones
        constexpr int PB = DQ % 16 ? 8 : 16;
#pragma unroll
        for (int c = 0; c < DQ / PB; ++c) {
          const int d0 = warp * DQ + c * PB;
          float kf[PB];
          if constexpr (PB == 16) {
            const uint4 u = *reinterpret_cast<const uint4*>(krow + d0);
            int8x4_to_float(u.x, kf);
            int8x4_to_float(u.y, kf + 4);
            int8x4_to_float(u.z, kf + 8);
            int8x4_to_float(u.w, kf + 12);
          } else {
            const uint2 u = *reinterpret_cast<const uint2*>(krow + d0);
            int8x4_to_float(u.x, kf);
            int8x4_to_float(u.y, kf + 4);
          }
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r < R) {
#pragma unroll
              for (int e = 0; e < PB / 4; ++e) {
                const float4 q4 = *reinterpret_cast<const float4*>(qs + r * HD + d0 + 4 * e);
                s[r] = fmaf(q4.x, kf[4 * e], s[r]);
                s[r] = fmaf(q4.y, kf[4 * e + 1], s[r]);
                s[r] = fmaf(q4.z, kf[4 * e + 2], s[r]);
                s[r] = fmaf(q4.w, kf[4 * e + 3], s[r]);
              }
            }
          }
        }
      } else {
        const float* kr = reinterpret_cast<const float*>(krow);
#pragma unroll 4
        for (int c = 0; c < DQ / 4; ++c) {
          const int d0 = warp * DQ + c * 4;
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d0);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r < R) {
              const float4 q4 = *reinterpret_cast<const float4*>(qs + r * HD + d0);
              s[r] = fmaf(q4.x, k4.x, s[r]);
              s[r] = fmaf(q4.y, k4.y, s[r]);
              s[r] = fmaf(q4.z, k4.z, s[r]);
              s[r] = fmaf(q4.w, k4.w, s[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) sp[(warp * RMAX + r) * kKeys + lane] = s[r];
    }
    __syncthreads();

    // softmax: the warp's rows, the lane's key; scale, cap, then mask
    const int key = t * kKeys + lane;
    const int pi = (key >> a.bs_shift) - p0;  // the key's page in the split
#pragma unroll
    for (int i2 = 0; i2 < RPS; ++i2) {
      const int r = warp + kWarps * i2;
      if (r < R) {
        float x = sp[r * kKeys + lane];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) x += sp[(v * RMAX + r) * kKeys + lane];
        if constexpr (INT8) x *= ksc[pi];
        x *= a.sm_scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const int pos = off + r % a.T;
        const bool vis = key >= kmin && key <= kmax && key <= pos &&
                         (a.window <= 0 || key > pos - a.window);
        x = vis ? x : -INFINITY;
        const float mnew = fmaxf(m[i2], warp_max(x));
        const float alpha = mnew == -INFINITY ? 1.f : expf(m[i2] - mnew);
        const float p = vis ? expf(x - mnew) : 0.f;
        l[i2] = l[i2] * alpha + warp_sum(p);
        m[i2] = mnew;
        if constexpr (INT8)
          ps[r * kKeys + lane] = p * vsc[pi];
        else
          ps[r * kKeys + lane] = p;
        if (lane == 0) as[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V over the warp's keys and rows
#pragma unroll
    for (int j = 0; j < kWarpRows; ++j) {
      const int r = rg * kWarpRows + j;
      if (r < R) {
        const float al = as[r];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[j][c] *= al;
      }
    }
#pragma unroll (PV_UNROLL)
    for (int k0 = kg * KPW; k0 < kg * KPW + KPW; k0 += 4) {
      float v[4][CPL];
#pragma unroll
      for (int e = 0; e < 4; ++e) load_v<HD, INT8>(vs + (k0 + e) * VROWB, lane, v[e]);
#pragma unroll
      for (int j = 0; j < kWarpRows; ++j) {
        const int r = rg * kWarpRows + j;
        if (r < R) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kKeys + k0);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[j][c] = fmaf(p4.x, v[0][c], acc[j][c]);
            acc[j][c] = fmaf(p4.y, v[1][c], acc[j][c]);
            acc[j][c] = fmaf(p4.z, v[2][c], acc[j][c]);
            acc[j][c] = fmaf(p4.w, v[3][c], acc[j][c]);
          }
        }
      }
    }
  }
  tile::cp_async_wait_all();
  __syncthreads();

  // the block's partial: (m, l) from each row's softmax owner, acc whole
  // from the warp that holds the row or summed over the key groups in warp
  // order
#pragma unroll
  for (int i2 = 0; i2 < RPS; ++i2) {
    const int r = warp + kWarps * i2;
    if (r < R && lane == 0) {
      ml[2 * r] = m[i2];
      ml[2 * r + 1] = l[i2];
    }
  }
  float* dst = WK == 1 ? acc_out : reinterpret_cast<float*>(ring) + (size_t)warp * RMAX * HD;
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j) {
    const int r = rg * kWarpRows + j;
    if (r < R) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) dst[(size_t)r * HD + lane_col<HD>(lane, c)] = acc[j][c];
    }
  }
  if constexpr (WK > 1) {
    __syncthreads();
    const float* wo = reinterpret_cast<const float*>(ring);
    for (int id = threadIdx.x; id < R * HD; id += kThreads) {
      float o = wo[id];
#pragma unroll
      for (int v = 1; v < WK; ++v) o += wo[(size_t)v * RMAX * HD + id];
      acc_out[id] = o;
    }
  }
  let_merge_launch();
}

// The splits of each row, merged in a fixed order. A split with l = 0
// (empty) weighs exactly 0, so exp(-inf - -inf) never arises; a row whose
// every split is empty writes 0. Grid B * Hkv * R, 128 threads: the threads
// read the splits' (m, l) together into shared memory; then HD / 4 lanes
// cover a row in 16-byte loads, and the 128 threads' groups take every
// `groups`-th split; the groups' sums add up in group order, and the row
// is divided by its l (IEEE division, as the plain version's).
// Launched as a programmatic dependent of the split walk: it waits for the
// walk's partials before it reads any.
template <int HD>
__global__ void __launch_bounds__(kThreads) ragged_decode_f32_merge(const DecodeF32Args a) {
  constexpr int LANES = HD / 4;  // threads a row takes, four floats each
  constexpr int GROUPS = kThreads / LANES;
  extern __shared__ float wsplit[];  // [splits] weights, then [splits] l
  __shared__ float wmax[kWarps];
  __shared__ __align__(16) float osum[GROUPS][HD];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = a.H / a.Hkv;
  const int R = G * a.T;
  const int bk = blockIdx.x / R;
  const int r = blockIdx.x % R;
  const size_t slot0 = (size_t)bk * a.splits * R + r;  // split s: slot0 + s * R
  const float* acc = a.part;
  const float* ml = a.part + (size_t)a.B * a.Hkv * a.splits * R * HD;
  float* ls = wsplit + a.splits;
  float m = -INFINITY;
  for (int s = threadIdx.x; s < a.splits; s += kThreads) {
    const size_t slot = slot0 + (size_t)s * R;
    wsplit[s] = ml[2 * slot];
    ls[s] = ml[2 * slot + 1];
    if (ls[s] > 0.f) m = fmaxf(m, wsplit[s]);
  }
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) m = fmaxf(m, wmax[v]);
  for (int s = threadIdx.x; s < a.splits; s += kThreads)
    wsplit[s] = ls[s] > 0.f ? expf(wsplit[s] - m) : 0.f;
  __syncthreads();
  const int grp = threadIdx.x / LANES;
  const int d4 = (threadIdx.x % LANES) * 4;
  float4 o = {0.f, 0.f, 0.f, 0.f};
  if (grp < GROUPS) {  // HD 96: 128 threads hold five whole groups
    for (int s = grp; s < a.splits; s += GROUPS) {
      const float f = wsplit[s];
      if (f > 0.f) {
        const float4 x =
            *reinterpret_cast<const float4*>(acc + (slot0 + (size_t)s * R) * HD + d4);
        o.x = fmaf(x.x, f, o.x);
        o.y = fmaf(x.y, f, o.y);
        o.z = fmaf(x.z, f, o.z);
        o.w = fmaf(x.w, f, o.w);
      }
    }
    *reinterpret_cast<float4*>(&osum[grp][d4]) = o;
  }
  __syncthreads();
  const int b = bk / a.Hkv;
  const int kvh = bk % a.Hkv;
  float* out = a.out + (((size_t)b * a.T + r % a.T) * a.H + kvh * G + r / a.T) * HD;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float l = 0.f, sum = 0.f;
    for (int s = 0; s < a.splits; ++s) l = fmaf(ls[s], wsplit[s], l);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) sum += osum[g][d];
    out[d] = l > 0.f ? sum / l : 0.f;
  }
}

template <int HD, bool INT8, int RMAX>
int launch(const DecodeF32Args& a, cudaStream_t stream) {
  const int R = a.H / a.Hkv * a.T;
  if (a.B * a.Hkv > 65535 || (long long)a.B * a.Hkv * R > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      fixed_smem_bytes<HD, INT8, RMAX>() + split_smem_bytes<INT8>(a.split_pages);
  auto kernel = ragged_decode_f32_kernel<HD, INT8, RMAX>;
  // once per instantiation, for the largest split, and the largest shared
  // memory carve-out, so that two blocks fit an SM where their rings allow
  static const cudaError_t attr = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(fixed_smem_bytes<HD, INT8, RMAX>() + split_smem_bytes<INT8>(kMaxSplitPages)));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3(a.splits, a.B * a.Hkv), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv * R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 2 * a.splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_decode_f32_merge<HD>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD, bool INT8>
int launch_rows(int R, const DecodeF32Args& a, cudaStream_t stream) {
  return R <= kWarpRows ? launch<HD, INT8, kWarpRows>(a, stream)
                        : launch<HD, INT8, kMaxRows>(a, stream);
}

template <bool INT8>
int launch_hd(int hd, int R, const DecodeF32Args& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_rows<64, INT8>(R, a, stream);
    case 96:
      return launch_rows<96, INT8>(R, a, stream);
    case 128:
      return launch_rows<128, INT8>(R, a, stream);
    case 256:
      return launch_rows<256, INT8>(R, a, stream);
  }
  return -1;
}

}  // namespace

// C entry point, bound with ctypes: both kernels, on `stream`. q and out
// are f32 ([B, T, H, hd] and [B, T, H * hd]), with (H / Hkv) * T <= 32.
// k_scale/v_scale null: the pools are f32; both set: the pools are int8
// with [Hkv, NB] f32 scales. `part` is f32 scratch of B * Hkv * splits *
// (H / Hkv) * T * (hd + 2) elements; the splits of `split_pages` pages
// must cover the table's MB pages exactly, each split whole 32-key tiles.
// Returns the first cudaError_t (0 = both launched), or -1 for a head_dim /
// block size / row count / split plan this file does not take.
extern "C" int b2b_ragged_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offset, void* out, void* part, int B, int T, int H, int Hkv,
    int NB, int MB, int BS, int hd, int window, int splits, int split_pages,
    float sm_scale, float softcap, void* stream) {
  const int bs_shift = BS == 8 ? 3 : BS == 16 ? 4 : BS == 32 ? 5 : -1;
  if (bs_shift < 0 || Hkv < 1 || T < 1 || H % Hkv) return -1;
  const int R = H / Hkv * T;
  // the merge keeps two floats a split in shared memory
  if (R < 1 || R > kMaxRows || splits < 1 || splits > 4096 || split_pages < 1 ||
      split_pages > kMaxSplitPages || (split_pages * BS) % kKeys ||
      (long long)splits * split_pages < MB || (long long)(splits - 1) * split_pages >= MB)
    return -1;
  const DecodeF32Args a{static_cast<const float*>(q), k_pool, v_pool,
                        static_cast<const float*>(k_scale),
                        static_cast<const float*>(v_scale),
                        static_cast<const int*>(tables),
                        static_cast<const int*>(offset), static_cast<float*>(out),
                        static_cast<float*>(part), B, T, H, Hkv, NB, MB, bs_shift,
                        window, splits, split_pages, sm_scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8_pool = k_scale != nullptr;
  if (int8_pool != (v_scale != nullptr)) return -1;
  return int8_pool ? launch_hd<true>(hd, R, a, s) : launch_hd<false>(hd, R, a, s);
}
