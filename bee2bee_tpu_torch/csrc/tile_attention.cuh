// Device helpers shared by the tensor-core tile attention kernels of this
// package: the ragged prefill kernel (ragged_prefill_attention.cu) and the
// bf16 flash kernel (flash_attention.cu). The row-per-warp kernels
// (attention.cuh) include none of it.
//
// The tile design (FlashAttention-2's shape, with mma.sync):
//   - a block of kWarps warps owns kRows = 64 query rows of one (batch row,
//     kv head); each warp owns 16 rows. Rows fold as (chunk position t
//     major, GQA group g minor), so the G heads that share a kv head sit in
//     one tile and every staged K/V tile serves all of them, and a tile
//     spans only 64 / G chunk positions of the causal frontier;
//   - Q is staged once through shared memory into registers as mma A
//     fragments (ldmatrix);
//   - keys come in tiles of kKeys = 64 rows of K and V in bf16 in shared
//     memory, in an XOR-swizzled layout (16-byte chunk c of row r sits at
//     chunk c ^ (r & 7); at HD 96 swz's split form) so that ldmatrix reads
//     8 rows without bank conflicts;
//   - S = Q K^T with mma.m16n8k16 (bf16 in, f32 accumulator), scaled,
//     tanh-capped, masked; the online softmax stays in f32 registers
//     (row max and row sum over the quad of lanes holding a row); P is
//     rounded to bf16, as the JAX kernel's p.astype(v.dtype), and
//     O += P V with V read through ldmatrix.trans;
//   - a 16-key group no row of the warp sees is neither multiplied nor
//     summed: its probabilities are exactly 0.
//
// At HD 256 that design would hold Q's fragments (64 registers a lane),
// the output accumulator (128) and S (32 at 64 keys) at once, about 224
// registers before addresses. The HD 256 form (WarpAcc) keeps Q in the
// swizzled shared-memory tile for the whole walk and loads each k-step's
// A fragment with ldmatrix where it is used, and its key tiles hold 32
// keys (S: 16 registers), FlashAttention-2's choice at this head_dim: the
// lane holds the 128-register accumulator and little else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kKeys = 64;           // keys per shared-memory tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from device to shared memory, asynchronous; with
// src_bytes = 0 nothing is read and the slot is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b for one 16x8 f32 tile: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// index of 16-byte chunk c of row r in a swizzled [rows][HD] bf16 tile.
// An ldmatrix phase reads one chunk c of 8 rows r0 .. r0 + 7 (r0 a
// multiple of 8); it is free of bank conflicts when those 8 chunks fall in
// 8 distinct 16-byte bank groups, (index mod 8).
//   HD 64, 128, 256 (a row of 8, 16 or 32 chunks): chunk c ^ (r & 7). The
//     row start is a multiple of 8 chunks, so the groups are c ^ (r & 7):
//     distinct over the 8 rows.
//   HD 96 (a row of 12 chunks): that XOR would send chunks 8-11 into 12-15,
//     the next row's chunks 0-3. The row splits instead into its aligned
//     group of 8 chunks, XORed as above, and a tail of 4, permuted inside
//     itself: chunk 8 + ((c ^ (r >> 1)) & 3). A row starts 12 r chunks in,
//     so its bank groups sit 4 (r & 1) apart: in the head the group is
//     (c ^ (r & 7)) ^ 4 (r & 1), a bijection of r & 7 (the XOR by
//     4 (r & 1) leaves bit 0 of r, which selects it, as it is); in the tail
//     it is 4 (r & 1) + ((c ^ (r >> 1)) & 3), whose two parts take bit 0
//     and bits 1-2 of r & 7 each once. Every chunk stays in its row, and the
//     tiles take no more shared memory than unswizzled ones.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int RC = HD / 8;
  static_assert(RC % 8 == 0 || RC == 12, "rows of 8k or 12 chunks");
  if constexpr (RC % 8 == 0)
    return r * RC + (c ^ (r & 7));
  else
    return r * RC + (c < 8 ? c ^ (r & 7) : 8 + ((c ^ (r >> 1)) & 3));
}

// one warp's 16 query rows: Q fragments, output accumulator, softmax state.
// Lane l holds rows l/4 (i = 0) and l/4 + 8 (i = 1) of the warp's 16.
template <int HD>
struct WarpRows {
  uint32_t q[HD / 16][4];
  float o[HD / 8][4];
  float m[2];
  float l[2];  // this lane's part of the row sum; the quad adds them last
};

// the same rows with Q left in shared memory (the HD 256 form): the output
// accumulator and softmax state alone
template <int HD>
struct WarpAcc {
  float o[HD / 8][4];
  float m[2];
  float l[2];
};

// the HD 256 form keeps Q resident in shared memory, in 32-key tiles
template <int HD>
__host__ __device__ constexpr bool q_resident() {
  return HD > 128;
}
template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return q_resident<HD>() ? 32 : kKeys;
}

// Rows r of the block's query tile, row r0 + r of the folded (t, g) order,
// staged from q [B, T, H, HD]: row R = t * G + g reads head kvh * G + g at
// chunk position t. Rows past nrows are zero-filled.
template <int HD>
__device__ __forceinline__ void stage_q(uint4* qs, const bf16* q, int b,
                                        int kvh, int T_, int H, int G,
                                        int r0, int nrows) {
  constexpr int RC = HD / 8;  // 16-byte chunks per row
  for (int id = threadIdx.x; id < kRows * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int R = r0 + r;
    const bf16* src = q;
    if (R < nrows) {
      const int t = R / G;
      src = q + ((size_t)(b * T_ + t) * H + kvh * G + R % G) * HD + c * 8;
    }
    cp_async16(qs + swz<HD>(r, c), src, R < nrows ? 16 : 0);
  }
}

template <int HD, class W>
__device__ __forceinline__ void init_acc(W& w) {
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

template <int HD>
__device__ __forceinline__ void init_rows(WarpRows<HD>& w, const uint4* qs,
                                          int warp, int lane) {
  const int r = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(w.q[kk], qs + swz<HD>(r, 2 * kk + (lane >> 4)));
  init_acc<HD>(w);
}

// Q's A fragment of k-step kk (dims 16 kk .. 16 kk + 15 of the warp's 16
// rows): from registers, or (WarpAcc) by ldmatrix from the warp's 16 rows
// of the swizzled Q tile at qw (qw: row 0 of the 16, a multiple of 8 rows
// into the tile, so the swizzle of row r is that of r & 15)
template <int HD>
__device__ __forceinline__ void q_frag(const WarpRows<HD>& w, const uint4*,
                                       int kk, int, uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = w.q[kk][e];
}
template <int HD>
__device__ __forceinline__ void q_frag(const WarpAcc<HD>&, const uint4* qw,
                                       int kk, int lane, uint32_t (&a)[4]) {
  ldmatrix_x4(a, qw + swz<HD>(lane & 15, 2 * kk + (lane >> 4)));
}

// 16-key groups of the tile at key position `base` that a key range
// [lo, hi] (the union over the warp's rows) touches, as a bit mask
template <int KEYS = kKeys>
__device__ __forceinline__ unsigned live_groups(int base, int lo, int hi) {
  unsigned live = 0;
#pragma unroll
  for (int gi = 0; gi < KEYS / 16; ++gi) {
    const int k0 = base + gi * 16;
    live |= (k0 <= hi && k0 + 15 >= lo) ? (1u << gi) : 0u;
  }
  return live;
}

// S = Q K^T for one key tile of KEYS keys: ldmatrix of K rows gives the
// col-major B operand directly. ALL: every 16-key group is live and no
// branch separates the products. qw: the warp's Q rows (WarpAcc only).
template <int HD, int KEYS, bool ALL, class W>
__device__ __forceinline__ void qk(float (&s)[KEYS / 8][4], const W& w,
                                   const uint4* qw, const uint4* ks,
                                   unsigned live, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    q_frag<HD>(w, qw, kk, lane, a);
#pragma unroll
    for (int np = 0; np < KEYS / 16; ++np) {
      if (!ALL && !(live >> np & 1u)) continue;
      const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      ldmatrix_x4(b, ks + swz<HD>(key, 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// O += P V for one key tile: the S accumulator of two 8-key tiles, as
// bf16, is the A fragment of a 16-key step; ldmatrix.trans of V rows gives
// the col-major B operand.
template <int HD, int KEYS, bool ALL, class W>
__device__ __forceinline__ void pv(W& w, const float (&p)[KEYS / 8][4],
                                   const uint4* vs, unsigned live, int lane) {
#pragma unroll
  for (int kc = 0; kc < KEYS / 16; ++kc) {
    if (!ALL && !(live >> kc & 1u)) continue;
    const uint32_t a[4] = {
        pack_bf16(p[2 * kc][0], p[2 * kc][1]),
        pack_bf16(p[2 * kc][2], p[2 * kc][3]),
        pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
        pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]),
    };
    const int key = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + swz<HD>(key, 2 * dp + (lane >> 4)));
      mma_bf16(w.o[2 * dp], a, b[0], b[1]);
      mma_bf16(w.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// One key tile of KEYS keys for one warp's rows. qw: the warp's Q rows in
// shared memory (WarpAcc; unused with Q in registers); ks, vs: the tile's
// K and V [KEYS][HD] bf16, swizzled. Row i of this lane sees tile keys
// lo[i] .. hi[i] (tile-local, inclusive; empty when lo > hi); `live` marks
// the 16-key groups any row of the warp sees.
template <int HD, int KEYS, class W>
__device__ __forceinline__ void attend_keys(W& w, const uint4* qw,
                                            const uint4* ks, const uint4* vs,
                                            unsigned live, const int (&lo)[2],
                                            const int (&hi)[2], float sm_scale,
                                            float softcap, int lane) {
  constexpr int NT = KEYS / 8;  // 8-key column tiles of S
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

  // S = Q K^T, on the fully seen tiles without a branch between the
  // products, so that the accumulators interleave
  if (live == (1u << (KEYS / 16)) - 1)
    qk<HD, KEYS, true>(s, w, qw, ks, live, lane);
  else
    qk<HD, KEYS, false>(s, w, qw, ks, live, lane);

  // scale, cap, mask; row max over the quad
  const int tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = n * 8 + tq * 2 + (e & 1);
      float x = s[n][e] * sm_scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = (key >= lo[i] && key <= hi[i]) ? x : -INFINITY;
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
  for (int n = 0; n < NT; ++n)
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

  if (live == (1u << (KEYS / 16)) - 1)
    pv<HD, KEYS, true>(w, s, vs, live, lane);
  else
    pv<HD, KEYS, false>(w, s, vs, live, lane);
}

// One 64-key tile, Q in registers (HD 64, 96 and 128)
template <int HD>
__device__ __forceinline__ void attend_tile(WarpRows<HD>& w, const uint4* ks,
                                            const uint4* vs, unsigned live,
                                            const int (&lo)[2],
                                            const int (&hi)[2], float sm_scale,
                                            float softcap, int lane) {
  attend_keys<HD, kKeys>(w, nullptr, ks, vs, live, lo, hi, sm_scale, softcap,
                         lane);
}

// One tile of tile_keys<HD>() keys, Q resident in shared memory at qw (the
// HD 256 form). A tile no row of the warp sees costs nothing: Q's
// fragments are not even loaded.
template <int HD>
__device__ __forceinline__ void attend_tile(WarpAcc<HD>& w, const uint4* qw,
                                            const uint4* ks, const uint4* vs,
                                            unsigned live, const int (&lo)[2],
                                            const int (&hi)[2], float sm_scale,
                                            float softcap, int lane) {
  if (!live) return;
  attend_keys<HD, tile_keys<HD>()>(w, qw, ks, vs, live, lo, hi, sm_scale,
                                   softcap, lane);
}

// Row i of this lane: its output row in out [B, T, H * HD] or nullptr for a
// padding row. A row that saw nothing (l == 0) writes 0.
template <int HD, class W>
__device__ __forceinline__ void store_rows(const W& w, bf16* const (&dst)[2],
                                           int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = w.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if (dst[i] == nullptr) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst[i] + n * 8 + tq * 2) =
          __floats2bfloat162_rn(w.o[n][2 * i] * inv, w.o[n][2 * i + 1] * inv);
  }
}

// The lane's two rows in the block-global folded order, their key ranges
// [kmin, kmax] (absolute positions; empty for padding rows), their output
// rows, and the warp's union of the ranges.
struct RowSpan {
  int kmin[2], kmax[2];
  int wlo, whi;
};

__device__ __forceinline__ RowSpan warp_span(const int (&kmin)[2],
                                             const int (&kmax)[2]) {
  RowSpan sp;
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sp.kmin[i] = kmin[i];
    sp.kmax[i] = kmax[i];
    if (kmin[i] <= kmax[i]) {
      lo = min(lo, kmin[i]);
      hi = max(hi, kmax[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  sp.wlo = lo;
  sp.whi = hi;
  return sp;
}

// the lane's tile-local ranges and the warp's live groups for the tile of
// KEYS keys at key position `base`
template <int KEYS = kKeys>
__device__ __forceinline__ unsigned tile_ranges(const RowSpan& sp, int base,
                                                int (&lo)[2], int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lo[i] = sp.kmin[i] - base;
    hi[i] = sp.kmax[i] - base;
  }
  return live_groups<KEYS>(base, sp.wlo, sp.whi);
}

}  // namespace tile
