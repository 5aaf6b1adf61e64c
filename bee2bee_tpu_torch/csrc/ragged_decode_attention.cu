// Ragged paged attention of decode steps for Hopper (sm_90a), split-K
// ("flash-decoding"): one bf16 query per batch row and head, attending to
// the row's pages of the paged KV pool through its block table.
//
// Replaces the TPU kernel bee2bee_tpu/ops/ragged.py:_ragged_kernel for
// decode (T = 1, bf16 queries at head_dim 64 and 128; ops/ragged.py
// dispatches), in both pool forms: the bf16 pool, and the int8 pool whose
// pages carry one f32 scale per (kv head, block), read beside tables[b, j].
// Same function: GQA rows folded g-major, per-row `offset`, one sliding
// `window` per call (0 = full causal), `sm_scale`, tanh `softcap` applied
// before the mask; a masked key is never read from the pool (its slot in
// shared memory is zero-filled), so the null block's garbage cannot reach
// a row; a row that sees nothing writes 0. An int8 page is dequantized in
// f32 and rounded to bf16 before the dots; P is rounded to bf16 before
// P V, as the JAX kernel's p.astype(v.dtype).
//
// What bounds it on an H100: a decode step reads every visible K/V page
// of every (row, kv head) once and does 4 * HD flops per key and query
// head, about 2 flops a byte; so it is bound by bytes (llama-3-8b heads,
// B = 8 at a 1024-token context: 33.6 MB, 0.0101 ms at 3.35 TB/s in bf16;
// 0.0051 ms over the int8 pool). The row kernel (ragged_attention.cu)
// reached 6% and 3% of that. The design aims at bytes in flight:
//   split the page walk of each (batch row, kv head) over `splits` blocks
//         of `split_pages` pages (ops/ragged.py:decode_splits, from host
//         shapes only), so the grid fills the 132 SMs at B = 1 as well;
//         a split wholly past its row's causal frontier or below its
//         window writes an empty partial (l = 0) and exits;
//   stage each tile of 64 keys (64 / BS pages) with 16-byte cp.async
//         copies into a ring of 3 stages (int8: 4), so two or three tiles
//         (64-96 KB) are in flight per block while one is consumed. A
//         bulk copy (cp.async.bulk + mbarrier) would move a whole page
//         with one thread, but it lands the page unswizzled (8-way bank
//         conflicts for ldmatrix at a 256-byte row) and cannot leave the
//         masked keys of a partly visible page unread;
//   serve the GQA group from one staged tile: the block's G query heads
//         (padded to 16 rows) are the M side of mma.sync m16n8k16, and the
//         4 warps split the tile's keys, 16 each, rather than the rows, so
//         each key is read from shared memory once per block. An int8 key
//         is dequantized once, by the warp that reads it;
//   merge each warp's online softmax (m, l, acc) in shared memory, write
//         the block's f32 partial to scratch that the wrapper allocates,
//         and let a second kernel merge the splits of each (row, head) in
//         split order, with no atomics: results repeat bit for bit.
// One C entry point launches both kernels. Instantiated for HD 64 and 128
// and BS 8, 16 and 32; HD 256 would hold 192 accumulator and fragment
// registers a lane, so it stays on the row kernel, as f32 queries do.

#include "tile_attention.cuh"

namespace {

using tile::bf16;
using tile::cp_async16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = kWarps * 16;  // keys per staged tile, 16 a warp
constexpr int kRows = 16;           // query heads per block (mma M)
constexpr int kMaxSplitPages = 2048;  // the split's table entries in smem

struct DecodeArgs {
  const bf16* q;         // [B, 1, H, HD]
  const void* k_pool;    // [Hkv, NB, BS, HD] bf16, or int8 with scales
  const void* v_pool;
  const float* k_scale;  // [Hkv, NB] scales of an int8 pool, else nullptr
  const float* v_scale;
  const int* tables;     // [B, MB]
  const int* offset;     // [B]: position of q[b, 0]
  bf16* out;             // [B, 1, H * HD]
  float* part;           // scratch: acc [.., HD] then (m, l), per (b, kvh, split, g)
  int B, H, Hkv, NB, MB, window, splits, split_pages;
  float sm_scale, softcap;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool INT8>
__host__ __device__ constexpr int stages() {
  return INT8 ? 4 : 3;
}

// shared memory: Q [kRows][HD] bf16 (swizzled), then the ring of stages,
//   bf16: [stage][K, V][kKeys][HD] bf16 (swizzled);
//   int8: [stage][K, V][kKeys][HD] int8, then one bf16 K, V tile
//         (swizzled) that each warp dequantizes its own keys into;
// then, sized at launch, the split's table entries [split_pages] and, for
// an int8 pool, its pages' scales [K, V][split_pages].
// After the walk the ring holds the warps' softmax states for the merge.
template <int HD, bool INT8>
__host__ __device__ constexpr size_t ring_bytes() {
  const size_t tilebf = (size_t)kKeys * HD * 2;
  if (!INT8) return stages<INT8>() * 2 * tilebf;
  return stages<INT8>() * 2 * (size_t)kKeys * HD + 2 * tilebf;
}
template <int HD, bool INT8>
__host__ __device__ constexpr size_t fixed_smem_bytes() {
  return (size_t)kRows * HD * 2 + ring_bytes<HD, INT8>();
}
template <bool INT8>
size_t split_smem_bytes(int split_pages) {
  return (size_t)split_pages * (INT8 ? 3 : 1) * 4;
}

// the warps' merge state: m, l [kWarps][kRows] and acc [kWarps][kRows][HD]
template <int HD, bool INT8>
__host__ __device__ constexpr bool merge_fits() {
  return (size_t)kWarps * kRows * (HD + 2) * sizeof(float) <=
         ring_bytes<HD, INT8>();
}

// Which keys the block reads: the row's visible keys [kmin, kmax] inside
// its split (absolute positions; empty when kmin > kmax), and the split's
// first page p0.
struct Span {
  int b, kvh, G, g0, rows, p0, kmin, kmax;
};

template <int BS>
__device__ __forceinline__ Span block_span(const DecodeArgs& a) {
  Span k;
  const int bk = blockIdx.y;
  k.b = bk / a.Hkv;
  k.kvh = bk % a.Hkv;
  k.G = a.H / a.Hkv;
  k.g0 = blockIdx.z * kRows;
  k.rows = min(kRows, k.G - k.g0);
  const int off = a.offset[k.b];
  const int split = blockIdx.x;
  k.p0 = split * a.split_pages;
  const int hi = min(k.p0 + a.split_pages, a.MB) * BS - 1;
  k.kmax = min(off, hi);
  k.kmin = max(a.window > 0 ? off - a.window + 1 : 0, k.p0 * BS);
  return k;
}

// Stage the tile of keys [base, base + kKeys): a key outside the block's
// span is not read and its slots are zero-filled. `blocks` holds the
// split's table entries.
template <int HD, int BS>
__device__ __forceinline__ void stage_bf16(const DecodeArgs& a, const Span& k,
                                           const int* blocks, int base,
                                           uint4* ks, uint4* vs) {
  constexpr int RC = HD / 8;
  const bf16* kp = static_cast<const bf16*>(a.k_pool);
  const bf16* vp = static_cast<const bf16*>(a.v_pool);
  for (int id = threadIdx.x; id < kKeys * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const int key = base + r;
    const bool vis = key >= k.kmin && key <= k.kmax;
    size_t src = 0;
    if (vis) {
      const int blk = blocks[key / BS - k.p0];
      src = (((size_t)k.kvh * a.NB + blk) * BS + key % BS) * HD + c * 8;
    }
    cp_async16(ks + tile::swz<HD>(r, c), kp + src, vis ? 16 : 0);
    cp_async16(vs + tile::swz<HD>(r, c), vp + src, vis ? 16 : 0);
  }
}

// The int8 form: bytes into kq/vq ([kKeys][HD], plain).
template <int HD, int BS>
__device__ __forceinline__ void stage_int8(const DecodeArgs& a, const Span& k,
                                           const int* blocks, int base,
                                           uint4* kq, uint4* vq) {
  constexpr int RC = HD / 16;
  const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
  const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
  for (int id = threadIdx.x; id < kKeys * RC; id += kThreads) {
    const int key = base + id / RC;
    const bool vis = key >= k.kmin && key <= k.kmax;
    size_t src = 0;
    if (vis) {
      const int blk = blocks[key / BS - k.p0];
      src = (((size_t)k.kvh * a.NB + blk) * BS + key % BS) * HD + (id % RC) * 16;
    }
    cp_async16(kq + id, kp + src, vis ? 16 : 0);
    cp_async16(vq + id, vp + src, vis ? 16 : 0);
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

// One warp's 16 keys (tile rows kw .. kw + 15) of the staged int8 tile at
// key `base`, dequantized into the bf16 tiles ks/vs (swizzled). `ksc`,
// `vsc`: the split's page scales (0 for a page the block does not read,
// whose bytes were zero-filled).
template <int HD, int BS>
__device__ __forceinline__ void dequant_keys(const uint4* kq, const uint4* vq,
                                             const float* ksc, const float* vsc,
                                             int page0, int npages, uint4* ks,
                                             uint4* vs, int kw, int lane) {
  constexpr int RC = HD / 16;
#pragma unroll
  for (int i = lane; i < 16 * RC; i += 32) {
    const int r = kw + i / RC;
    const int c = i % RC;
    const int pi = page0 + r / BS;  // the page within the split
    const bool in = pi >= 0 && pi < npages;
    uint4 lo, hi;
    dequant16(kq[r * RC + c], in ? ksc[pi] : 0.f, lo, hi);
    ks[tile::swz<HD>(r, 2 * c)] = lo;
    ks[tile::swz<HD>(r, 2 * c + 1)] = hi;
    dequant16(vq[r * RC + c], in ? vsc[pi] : 0.f, lo, hi);
    vs[tile::swz<HD>(r, 2 * c)] = lo;
    vs[tile::swz<HD>(r, 2 * c + 1)] = hi;
  }
}

// the merge kernel may start launching once every block of the split walk
// has written its partial (programmatic dependent launch)
__device__ __forceinline__ void let_merge_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <int HD, int BS, bool INT8>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const DecodeArgs a) {
  constexpr int S = stages<INT8>();
  constexpr int RC = HD / 8;           // 16-byte chunks of a bf16 row
  constexpr int TILE = kKeys * RC;     // uint4 chunks of a bf16 K or V tile
  constexpr int TILE8 = kKeys * HD / 16;  // the same of an int8 tile
  static_assert(kKeys % BS == 0, "a tile must hold whole pages");
  static_assert(merge_fits<HD, INT8>(), "merge state must fit the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qs = reinterpret_cast<uint4*>(smem);
  uint4* ring = qs + kRows * RC;
  uint4* deq = ring + S * 2 * TILE8;  // int8 form: the bf16 tile pair
  int* blocks = reinterpret_cast<int*>(smem + fixed_smem_bytes<HD, INT8>());
  float* ksc = reinterpret_cast<float*>(blocks + a.split_pages);
  float* vsc = ksc + a.split_pages;

  // the split's table entries, read while the offset is: two loads in
  // flight where a page-by-page lookup would chain them
  const int split = blockIdx.x;
  const int* row_table = a.tables + (blockIdx.y / a.Hkv) * a.MB;
  for (int i = threadIdx.x; i < a.split_pages; i += kThreads) {
    const int page = split * a.split_pages + i;
    blocks[i] = page < a.MB ? row_table[page] : 0;
  }
  const Span k = block_span<BS>(a);
  const size_t slot0 = ((size_t)blockIdx.y * a.splits + split) * k.G + k.g0;
  float* acc_out = a.part + slot0 * HD;
  float* ml = a.part + (size_t)a.B * a.Hkv * a.splits * k.G * HD + 2 * slot0;

  if (k.kmin > k.kmax) {  // the split lies past the frontier or below the window
    for (int r = threadIdx.x; r < k.rows; r += kThreads) {
      ml[2 * r] = -INFINITY;
      ml[2 * r + 1] = 0.f;
    }
    let_merge_launch();
    return;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = k.kmin / kKeys;
  const int t1 = k.kmax / kKeys;

  auto load_tile = [&](int t, int st) {
    if (t > t1) return;
    if constexpr (INT8) {
      uint4* kq = ring + st * 2 * TILE8;
      stage_int8<HD, BS>(a, k, blocks, t * kKeys, kq, kq + TILE8);
    } else {
      uint4* ks = ring + st * 2 * TILE;
      stage_bf16<HD, BS>(a, k, blocks, t * kKeys, ks, ks + TILE);
    }
  };

  // Q: the block's query heads kvh * G + g0 + r, zero rows past the group
  for (int id = threadIdx.x; id < kRows * RC; id += kThreads) {
    const int r = id / RC;
    const int c = id % RC;
    const bf16* src = a.q;
    if (r < k.rows)
      src = a.q + ((size_t)k.b * a.H + k.kvh * k.G + k.g0 + r) * HD + c * 8;
    cp_async16(qs + tile::swz<HD>(r, c), src, r < k.rows ? 16 : 0);
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
      const int first = (k.p0 + i) * BS;
      const bool vis = first <= k.kmax && first + BS - 1 >= k.kmin;
      ksc[i] = vis ? a.k_scale[k.kvh * a.NB + blocks[i]] : 0.f;
      vsc[i] = vis ? a.v_scale[k.kvh * a.NB + blocks[i]] : 0.f;
    }
  }
  cp_async_wait<S - 2>();
  __syncthreads();

  tile::WarpRows<HD> w;
  tile::init_rows<HD>(w, qs, 0, lane);  // every warp holds all 16 rows
  const int kw = warp * 16;             // the warp's keys in each tile
  const int tq = lane & 3;

  for (int t = t0, i = 0; t <= t1; ++t, ++i) {
    // tile t has landed; every warp is done with the stage it replaces
    cp_async_wait<S - 2>();
    __syncthreads();
    load_tile(t + S - 1, (i + S - 1) % S);
    tile::cp_async_commit();
    const int st = i % S;
    const int wk0 = t * kKeys + kw;
    if (wk0 > k.kmax || wk0 + 15 < k.kmin) continue;  // no key of the warp seen
    const uint4* ks;
    const uint4* vs;
    if constexpr (INT8) {
      const uint4* kq = ring + st * 2 * TILE8;
      dequant_keys<HD, BS>(kq, kq + TILE8, ksc, vsc, t * kKeys / BS - k.p0,
                           a.split_pages, deq, deq + TILE, kw, lane);
      __syncwarp();
      ks = deq;
      vs = deq + TILE;
    } else {
      ks = ring + st * 2 * TILE;
      vs = ks + TILE;
    }

    // S = Q K^T over the warp's 16 keys: two 8-key column tiles
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int key = kw + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      tile::ldmatrix_x4(b, ks + tile::swz<HD>(key, 2 * kk + ((lane >> 3) & 1)));
      tile::mma_bf16(s[0], w.q[kk], b[0], b[1]);
      tile::mma_bf16(s[1], w.q[kk], b[2], b[3]);
    }
    // scale, cap, mask (one position per row: every row sees the same
    // keys); the online softmax over the quad holding a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = wk0 + n * 8 + tq * 2 + (e & 1);
        float x = s[n][e] * a.sm_scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        x = (key >= k.kmin && key <= k.kmax) ? x : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], mnew[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      mnew[i2] = fmaxf(w.m[i2], mx[i2]);
      alpha[i2] = mnew[i2] == -INFINITY ? 1.f : __expf(w.m[i2] - mnew[i2]);
      w.m[i2] = mnew[i2];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1;
        const float p = s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - mnew[i2]);
        s[n][e] = p;
        rs[i2] += p;
      }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) w.l[i2] = w.l[i2] * alpha[i2] + rs[i2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      w.o[n][0] *= alpha[0];
      w.o[n][1] *= alpha[0];
      w.o[n][2] *= alpha[1];
      w.o[n][3] *= alpha[1];
    }
    // O += P V: P, rounded to bf16, is the A fragment of one 16-key step
    const uint32_t pa[4] = {
        tile::pack_bf16(s[0][0], s[0][1]), tile::pack_bf16(s[0][2], s[0][3]),
        tile::pack_bf16(s[1][0], s[1][1]), tile::pack_bf16(s[1][2], s[1][3]),
    };
    const int vkey = kw + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      tile::ldmatrix_x4_trans(b, vs + tile::swz<HD>(vkey, 2 * dp + (lane >> 4)));
      tile::mma_bf16(w.o[2 * dp], pa, b[0], b[1]);
      tile::mma_bf16(w.o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
  tile::cp_async_wait_all();
  __syncthreads();

  // merge the four warps' states in shared memory, in warp order
  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][kRows]
  float* wl = wm + kWarps * kRows;
  float* wo = wl + kWarps * kRows;  // [kWarps][kRows][HD]
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float l = w.l[i2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = (lane >> 2) + 8 * i2;
    if (tq == 0) {
      wm[warp * kRows + r] = w.m[i2];
      wl[warp * kRows + r] = l;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float* o = wo + (warp * kRows + r) * HD + n * 8 + tq * 2;
      o[0] = w.o[n][2 * i2];
      o[1] = w.o[n][2 * i2 + 1];
    }
  }
  __syncthreads();
  for (int id = threadIdx.x; id < k.rows * HD; id += kThreads) {
    const int r = id / HD;
    const int d = id % HD;
    float m = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      if (wl[v * kRows + r] > 0.f) m = fmaxf(m, wm[v * kRows + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float lv = wl[v * kRows + r];
      if (lv > 0.f) {  // a warp that saw nothing weighs exactly 0
        const float f = __expf(wm[v * kRows + r] - m);
        l += lv * f;
        acc += wo[(v * kRows + r) * HD + d] * f;
      }
    }
    acc_out[(size_t)r * HD + d] = acc;
    if (d == 0) {
      ml[2 * r] = m;
      ml[2 * r + 1] = l;
    }
  }
  let_merge_launch();
}

// The splits of each (batch row, query head), merged in split order. A
// split with l = 0 (empty) weighs exactly 0, so exp(-inf - -inf) never
// arises; a row whose every split is empty writes 0. Grid B * H, 128
// threads: the threads read the splits' (m, l) together into shared
// memory; then HD / 4 lanes cover a row in 16-byte loads, and the 128
// threads' groups take every `groups`-th split, so a row's partials are
// read in one or two rounds; the groups' sums add up in group order.
// Launched as a programmatic dependent of the split walk: it waits for
// the walk's partials before it reads any.
template <int HD>
__global__ void __launch_bounds__(kThreads) ragged_decode_merge(const DecodeArgs a) {
  constexpr int LANES = HD / 4;  // threads a row takes, four floats each
  constexpr int GROUPS = kThreads / LANES;
  extern __shared__ float wsplit[];  // [splits] weights, then [splits] l
  __shared__ float wmax[kWarps];
  __shared__ __align__(16) float osum[GROUPS][HD];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = a.H / a.Hkv;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const size_t slot0 = ((size_t)(b * a.Hkv + h / G) * a.splits) * G + h % G;
  const float* acc = a.part;
  const float* ml = a.part + (size_t)a.B * a.Hkv * a.splits * G * HD;
  float* ls = wsplit + a.splits;
  float m = -INFINITY;
  for (int s = threadIdx.x; s < a.splits; s += kThreads) {
    const size_t slot = slot0 + (size_t)s * G;
    wsplit[s] = ml[2 * slot];
    ls[s] = ml[2 * slot + 1];
    if (ls[s] > 0.f) m = fmaxf(m, wsplit[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) m = fmaxf(m, wmax[v]);
  for (int s = threadIdx.x; s < a.splits; s += kThreads)
    wsplit[s] = ls[s] > 0.f ? __expf(wsplit[s] - m) : 0.f;
  __syncthreads();
  const int grp = threadIdx.x / LANES;
  const int d4 = (threadIdx.x % LANES) * 4;
  float4 o = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = grp; s < a.splits; s += GROUPS) {
    const float f = wsplit[s];
    if (f > 0.f) {
      const float4 x = *reinterpret_cast<const float4*>(
          acc + (slot0 + (size_t)s * G) * HD + d4);
      o.x += x.x * f;
      o.y += x.y * f;
      o.z += x.z * f;
      o.w += x.w * f;
    }
  }
  *reinterpret_cast<float4*>(&osum[grp][d4]) = o;
  __syncthreads();
  if (threadIdx.x < HD) {
    float l = 0.f, out = 0.f;
    for (int s = 0; s < a.splits; ++s) l += ls[s] * wsplit[s];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) out += osum[g][threadIdx.x];
    a.out[(size_t)blockIdx.x * HD + threadIdx.x] =
        __float2bfloat16(l > 0.f ? out / l : 0.f);
  }
}

template <int HD, int BS, bool INT8>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const int groups = (G + kRows - 1) / kRows;
  if (a.B * a.Hkv > 65535 || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.splits, a.B * a.Hkv, groups);
  const size_t smem =
      fixed_smem_bytes<HD, INT8>() + split_smem_bytes<INT8>(a.split_pages);
  auto kernel = ragged_decode_kernel<HD, BS, INT8>;
  // once per instantiation, for the largest split: the attribute outlives
  // the call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(fixed_smem_bytes<HD, INT8>() + split_smem_bytes<INT8>(kMaxSplitPages)));
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 2 * a.splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_decode_merge<HD>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD, bool INT8>
int launch_bs(int BS, const DecodeArgs& a, cudaStream_t stream) {
  switch (BS) {
    case 8:
      return launch<HD, 8, INT8>(a, stream);
    case 16:
      return launch<HD, 16, INT8>(a, stream);
    case 32:
      return launch<HD, 32, INT8>(a, stream);
  }
  return -1;
}

template <bool INT8>
int launch_hd(int hd, int BS, const DecodeArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_bs<64, INT8>(BS, a, stream);
    case 128:
      return launch_bs<128, INT8>(BS, a, stream);
  }
  return -1;
}

}  // namespace

// C entry point, bound with ctypes: both kernels, on `stream`. q and out
// are bf16 ([B, 1, H, hd] and [B, 1, H * hd]). k_scale/v_scale null: the
// pools are bf16; both set: the pools are int8 with [Hkv, NB] f32 scales.
// `part` is f32 scratch of B * Hkv * splits * (H / Hkv) * (hd + 2)
// elements; the splits of `split_pages` pages must cover the table's MB
// pages exactly. Returns the first cudaError_t (0 = both launched), or -1
// for a head_dim / block size / split plan this file does not take.
extern "C" int b2b_ragged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offset, void* out, void* part, int B, int H, int Hkv, int NB,
    int MB, int BS, int hd, int window, int splits, int split_pages,
    float sm_scale, float softcap, void* stream) {
  // the merge keeps two floats a split in shared memory
  if (splits < 1 || splits > 4096 || split_pages < 1 ||
      split_pages > kMaxSplitPages || (long long)splits * split_pages < MB ||
      (long long)(splits - 1) * split_pages >= MB)
    return -1;
  const DecodeArgs a{static_cast<const bf16*>(q), k_pool, v_pool,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(offset), static_cast<bf16*>(out),
                     static_cast<float*>(part), B, H, Hkv, NB, MB, window,
                     splits, split_pages, sm_scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8_pool = k_scale != nullptr;
  if (int8_pool != (v_scale != nullptr)) return -1;
  return int8_pool ? launch_hd<true>(hd, BS, a, s) : launch_hd<false>(hd, BS, a, s);
}
