// Device helpers of the f32 tensor-core tile attention kernels: the f32
// forms of the ragged prefill kernel (ragged_prefill_attention.cu) and of
// the flash tile kernel (flash_attention.cu). They reuse the bf16 tile
// helpers of tile_attention.cuh (cp.async, the warps' key spans).
//
// The f32 tile design, tile_attention.cuh's block shape in f32:
//   - a block of 4 warps owns 64 query rows of one (batch row, kv head),
//     16 a warp, folded (chunk position t major, GQA group g minor) so a
//     staged K/V tile serves the whole GQA group;
//   - both products run on mma.sync m16n8k8 with TF32 operands and f32
//     accumulators, in three products (3xTF32): each f32 operand splits as
//     hi = tf32(x), lo = tf32(x - hi) (cvt.rna's rounding: to nearest,
//     ties away; split() below), and
//     a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first.
//     The dropped a_lo b_lo is ~2^-22 of the product, where one TF32
//     product keeps ~2^-11: close to f32 accuracy;
//   - a block whose rows fit one warp (decode: G rows) splits the keys
//     instead: warp w takes 8-key group w of every tile for the same 16
//     rows, and the four partial softmaxes merge through shared memory at
//     the end (merge_warps), so no warp idles while one walks the keys;
//   - P stays f32 (the JAX kernel's p.astype(v.dtype) is the identity in
//     f32): it is split like any operand, and the row sum adds the
//     unrounded p;
//   - Q stays in shared memory, 64 rows x HD f32 (32 KB at HD 128; as hi
//     and lo fragments in registers it would take 128 registers a lane),
//     and each warp loads and splits its fragments per k-step;
//   - keys come in tiles of kKeys = 32 rows of K and V in f32,
//     double-buffered with 16-byte cp.async copies. ldmatrix is b16-only,
//     so fragments come from 32-bit and 64-bit ld.shared, and rows are
//     padded so a warp's fragment load hits 32 distinct banks: Q and K
//     rows by 8 floats (a lane reads dims 2t, 2t + 1 of a row as one
//     8-byte load: 4 rows of 8 floats a half-warp), V rows by 4 floats
//     (a lane reads V rows 2t and 2t + 1 of a group at column g);
//   - C -> A without shuffles. An m16n8 accumulator lane (g, t) holds keys
//     2t, 2t + 1 of its 8-key group, where the A fragment of P V wants
//     columns t and t + 4. P V sums over keys, so the key order inside a
//     group is free: a0/a2 come from the lane's own c0/c1 (row g), a1/a3
//     from c2/c3 (row g + 8), and the B fragment reads V rows 2t (b0) and
//     2t + 1 (b1). The same freedom over the head dimension lets Q K^T read
//     dims 2t, 2t + 1 of Q and K as one 8-byte load;
//   - an 8-key group no row of the warp sees is neither multiplied nor
//     summed.

#pragma once

#include "tile_attention.cuh"

namespace tile32 {

constexpr int kWarps = tile::kWarps;
constexpr int kThreads = tile::kThreads;
constexpr int kRows = tile::kRows;  // query rows per block
constexpr int kKeys = 32;           // keys per shared-memory tile
constexpr int kGroups = kKeys / 8;  // 8-key groups: S column tiles, P V k-steps

// floats per row of the Q and K tiles, and of the V tile
template <int HD>
__host__ __device__ constexpr int qk_stride() {
  return HD + 8;
}
template <int HD>
__host__ __device__ constexpr int v_stride() {
  return HD + 4;
}
// floats of a K tile, a V tile, the Q tile
template <int HD>
__host__ __device__ constexpr int k_tile() {
  return kKeys * qk_stride<HD>();
}
template <int HD>
__host__ __device__ constexpr int v_tile() {
  return kKeys * v_stride<HD>();
}
template <int HD>
__host__ __device__ constexpr int q_tile() {
  return kRows * qk_stride<HD>();
}

// x = hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi), each rounded as
// cvt.rna.tf32.f32 rounds a finite value (to nearest, ties away from
// zero): half a TF32 unit added to the pattern's magnitude (+0x1000), the
// 13 low bits then dropped. hi drops them itself (x - hi needs its exact
// value); the tensor cores ignore them in lo, as nvcc's own code for
// cvt.rna assumes. That is 4 instructions a split, where cvt.rna compiles
// to 7 here (a finiteness test and a select per conversion); every
// operand here is finite (a NaN could lose its payload to the sign bit).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
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

// d += a b in 3xTF32: the two small products, then the big one
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// one warp's 16 query rows: output accumulator and softmax state. Lane l
// holds rows l/4 (i = 0) and l/4 + 8 (i = 1) of the warp's 16.
template <int HD>
struct WarpRows {
  float o[HD / 8][4];
  float m[2];
  float l[2];  // this lane's part of the row sum; the quad adds them last
};

template <int HD>
__device__ __forceinline__ void init_rows(WarpRows<HD>& w) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) w.o[n][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w.m[i] = -INFINITY;
    w.l[i] = 0.f;
  }
}

// Rows r of the block's query tile, row r0 + r of the folded (t, g) order,
// staged from q [B, T, H, HD] f32 into qs [kRows][HD + 8]: row R = t * G + g
// reads head kvh * G + g at chunk position t. Rows past nrows are
// zero-filled.
template <int HD>
__device__ __forceinline__ void stage_q(float* qs, const float* q, int b, int kvh,
                                        int T_, int H, int G, int r0, int nrows) {
  constexpr int RC = HD / 4;  // 16-byte chunks per row
  for (int id = threadIdx.x; id < kRows * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int R = r0 + r;
    const float* src = q;
    if (R < nrows) {
      const int t = R / G;
      src = q + ((size_t)(b * T_ + t) * H + kvh * G + R % G) * HD + c * 4;
    }
    tile::cp_async16(qs + r * qk_stride<HD>() + c * 4, src, R < nrows ? 16 : 0);
  }
}

// 8-key groups of the tile at key position `base` that a key range
// [lo, hi] (the union over the warp's rows) touches, as a bit mask
__device__ __forceinline__ unsigned live_groups(int base, int lo, int hi) {
  unsigned live = 0;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int k0 = base + gi * 8;
    live |= (k0 <= hi && k0 + 7 >= lo) ? (1u << gi) : 0u;
  }
  return live;
}

// the lane's tile-local ranges and the warp's live groups for the tile at
// key position `base`
__device__ __forceinline__ unsigned tile_ranges(const tile::RowSpan& sp, int base,
                                                int (&lo)[2], int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lo[i] = sp.kmin[i] - base;
    hi[i] = sp.kmax[i] - base;
  }
  return live_groups(base, sp.wlo, sp.whi);
}

// S = Q K^T for one key tile. k-step kk covers dims kk*8 .. kk*8 + 7; the
// fragment's columns t and t + 4 are dims 2t and 2t + 1 of the step, in A
// (rows g, g + 8 of the warp's Q) and B (key g of the group) alike. ALL:
// every group is live and no branch separates the products.
template <int HD, bool ALL>
__device__ __forceinline__ void qk(float (&s)[kGroups][4], const float* qs,
                                   const float* ks, unsigned live, int row0,
                                   int lane) {
  constexpr int QS = qk_stride<HD>();
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* q0 = qs + (row0 + g) * QS + 2 * t;
  const float* k0 = ks + g * QS + 2 * t;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(q0 + kk * 8);
    const float2 x1 = *reinterpret_cast<const float2*>(q0 + 8 * QS + kk * 8);
    uint32_t ahi[4], alo[4];
    split(x0.x, ahi[0], alo[0]);
    split(x1.x, ahi[1], alo[1]);
    split(x0.y, ahi[2], alo[2]);
    split(x1.y, ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      if (!ALL && !(live >> n & 1u)) continue;
      const float2 y = *reinterpret_cast<const float2*>(k0 + n * 8 * QS + kk * 8);
      uint32_t bhi[2], blo[2];
      split(y.x, bhi[0], blo[0]);
      split(y.y, bhi[1], blo[1]);
      mma3(s[n], ahi, alo, bhi, blo);
    }
  }
}

// O += P V for one key tile: group kc of the S accumulator is the A
// fragment of one k-step as it lies (keys 2t, 2t + 1 as the columns t,
// t + 4), and B reads V rows 2t and 2t + 1 of the group to match.
template <int HD, bool ALL>
__device__ __forceinline__ void pv(WarpRows<HD>& w, const float (&p)[kGroups][4],
                                   const float* vs, unsigned live, int lane) {
  constexpr int VS = v_stride<HD>();
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kGroups; ++kc) {
    if (!ALL && !(live >> kc & 1u)) continue;
    uint32_t ahi[4], alo[4];
    split(p[kc][0], ahi[0], alo[0]);  // row g, key 2t
    split(p[kc][2], ahi[1], alo[1]);  // row g + 8, key 2t
    split(p[kc][1], ahi[2], alo[2]);  // row g, key 2t + 1
    split(p[kc][3], ahi[3], alo[3]);  // row g + 8, key 2t + 1
    const float* v0 = vs + (kc * 8 + 2 * t) * VS + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t bhi[2], blo[2];
      split(v0[n * 8], bhi[0], blo[0]);
      split(v0[VS + n * 8], bhi[1], blo[1]);
      mma3(w.o[n], ahi, alo, bhi, blo);
    }
  }
}

// One key tile for one warp's rows, rows row0 .. row0 + 15 of the block's
// Q tile qs; ks, vs: the tile's K [kKeys][HD + 8] and V [kKeys][HD + 4].
// Row i of this lane sees tile keys lo[i] .. hi[i] (tile-local, inclusive;
// empty when lo > hi); `live` marks the 8-key groups the warp takes that
// any of its rows sees.
template <int HD>
__device__ __forceinline__ void attend_tile(WarpRows<HD>& w, const float* qs,
                                            const float* ks, const float* vs,
                                            unsigned live, const int (&lo)[2],
                                            const int (&hi)[2], float sm_scale,
                                            float softcap, int row0, int lane) {
  if (!live) return;  // no row of the warp sees a key of this tile
  float s[kGroups][4];
#pragma unroll
  for (int n = 0; n < kGroups; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

  constexpr unsigned kAll = (1u << kGroups) - 1;
  if (live == kAll)
    qk<HD, true>(s, qs, ks, live, row0, lane);
  else
    qk<HD, false>(s, qs, ks, live, row0, lane);

  // scale, cap, mask (keys of groups the warp does not take too); row max
  // over the quad
  const int tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kGroups; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = n * 8 + tq * 2 + (e & 1);
      float x = s[n][e] * sm_scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = (live >> n & 1u) && key >= lo[i] && key <= hi[i] ? x : -INFINITY;
      s[n][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  float alpha[2], mnew[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mnew[i] = fmaxf(w.m[i], mx[i]);
    // nothing seen yet: keep the (zero) accumulator as it is
    alpha[i] = mnew[i] == -INFINITY ? 1.f : __expf(w.m[i] - mnew[i]);
    w.m[i] = mnew[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kGroups; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - mnew[i]);
      s[n][e] = p;
      rs[i] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) w.l[i] = w.l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    w.o[n][0] *= alpha[0];
    w.o[n][1] *= alpha[0];
    w.o[n][2] *= alpha[1];
    w.o[n][3] *= alpha[1];
  }

  if (live == kAll)
    pv<HD, true>(w, s, vs, live, lane);
  else
    pv<HD, false>(w, s, vs, live, lane);
}

// Key-split blocks: every warp has walked its own quarter of the keys for
// the same 16 rows; warp 0 takes the merged softmax (each partial weighted
// by exp(m_w - m), one that saw nothing by exactly 0). scratch: shared
// memory for (HD / 2 + 4) * 32 * kWarps floats that no copy is in flight
// to and no warp still reads.
template <int HD>
__device__ __forceinline__ void merge_warps(WarpRows<HD>& w, float* scratch,
                                            int warp, int lane) {
  constexpr int NO = HD / 8 * 4;  // accumulator floats a lane
  constexpr int PART = (NO + 4) * 32;
  float* mine = scratch + warp * PART;
#pragma unroll
  for (int j = 0; j < NO; ++j) mine[j * 32 + lane] = w.o[j / 4][j % 4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mine[(NO + i) * 32 + lane] = w.m[i];
    mine[(NO + 2 + i) * 32 + lane] = w.l[i];
  }
  __syncthreads();
  if (warp != 0) return;
  float scale[kWarps][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) m = fmaxf(m, scratch[v * PART + (NO + i) * 32 + lane]);
    float l = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float mv = scratch[v * PART + (NO + i) * 32 + lane];
      scale[v][i] = mv == -INFINITY ? 0.f : __expf(mv - m);
      l += scratch[v * PART + (NO + 2 + i) * 32 + lane] * scale[v][i];
    }
    w.m[i] = m;
    w.l[i] = l;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    float o = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      o += scratch[v * PART + j * 32 + lane] * scale[v][(j % 4) >> 1];
    w.o[j / 4][j % 4] = o;
  }
}

// floats of merge_warps' scratch
template <int HD>
__host__ __device__ constexpr int merge_floats() {
  return (HD / 2 + 4) * 32 * kWarps;
}

// Row i of this lane: its output row in out [B, T, H * HD] f32, or nullptr
// for a padding row. A row that saw nothing (l == 0) writes 0. o / l is a
// correctly rounded division, as the plain version's: a reciprocal times
// o is an ulp off at times, 8e-3 at the magnitude of an int8 null block.
template <int HD>
__device__ __forceinline__ void store_rows(const WarpRows<HD>& w,
                                           float* const (&dst)[2], int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = w.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (dst[i] == nullptr) continue;
    const float d = l > 0.f ? l : 1.f;  // nothing seen: o is 0
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst[i] + n * 8 + tq * 2) =
          make_float2(w.o[n][2 * i] / d, w.o[n][2 * i + 1] / d);
  }
}

}  // namespace tile32
