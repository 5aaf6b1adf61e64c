// Ragged paged attention for Hopper (sm_90a): causal GQA attention of a
// [B, T] query chunk read straight from the paged KV pool through per-row
// block tables.
//
// Replaces the TPU kernel bee2bee_tpu/ops/ragged.py:_ragged_kernel in both
// of its forms: the pool in the query's type (bf16 or f32), and the int8
// pool (quantized=True) whose pages carry one f32 scale per (kv head,
// block). Same function: queries fold to rows of (kv head, GQA group g
// major, chunk position t minor); per-row `offset`, one sliding `window`
// per call (0 = full causal), `sm_scale`, tanh `softcap` applied before
// the mask; pages past the causal frontier or wholly below the window are
// skipped; a row that sees nothing writes 0, never 0/0.
//
// The int8 form reads k_scale[kvh * NB + blk] beside tables[b, j] itself
// (the JAX wrapper's pre-gather of the scales to [Hkv, B, MB] exists only
// to fit TPU SMEM). One 16-byte load carries 16 int8 elements, so a page
// costs half the bytes and half the shared memory of bf16; each element is
// dequantized on its read from shared memory and rounded to the query type
// before the dot, as the reference does.
//
// What bounds it on an H100: a decode step reads every visible K/V page of
// every row once and does 4 flops per key element, far below the ~295
// flops/byte the tensor cores need, so it is bound by memory bandwidth
// (3.35 TB/s). The design reads each page from device memory once per
// block with 16-byte loads into shared memory, and all of the block's
// query rows (the GQA group for decode) use it from there.
//
// The design, kept simple on purpose:
//   grid  (B * Hkv, ceil(G * T / kWarps)); a block owns kWarps query rows
//         of one (batch row, kv head), one warp per row;
//   loop  over the block's visible pages: the block reads offset[b],
//         window and tables[b, j] (and an int8 page's scales) itself and
//         stages page j's K and V [BS, HD] in shared memory;
//   score each warp computes its row's BS scores with the lanes split
//         over HD (HD / 32 elements a lane) and a shuffle reduction;
//   softmax online, in f32, with the accumulator in registers;
//   out   written straight into [B, T, H * HD].
// Left for later: splitting a row's pages across blocks and merging the
// partial softmaxes (flash-decoding) when B * Hkv is small next to the 132
// SMs, and wgmma tiles for long prefill chunks, where the scalar dot
// products below leave the tensor cores idle (and where every row of an
// int8 page dequantizes it again).

#include "attention.cuh"

namespace {

struct RaggedArgs {
  const void* q;         // [B, T, H, HD]
  const void* k_pool;    // [Hkv, NB, BS, HD]
  const void* v_pool;
  const float* k_scale;  // [Hkv, NB] scales of an int8 pool, else nullptr
  const float* v_scale;
  const int* tables;     // [B, MB]
  const int* offset;     // [B]: position of q[b, 0]
  void* out;             // [B, T, H * HD]
  int B, T, H, Hkv, NB, MB, window;
  float sm_scale, softcap;
};

// T: query/output type; P: pool type (T, or int8_t with per-page scales)
template <typename T, typename P, int HD, int BS>
__global__ void __launch_bounds__(kWarps * 32)
ragged_paged_attention_kernel(
    const T* __restrict__ q,            // [B, T, H, HD]
    const P* __restrict__ k_pool,       // [Hkv, NB, BS, HD]
    const P* __restrict__ v_pool,       // [Hkv, NB, BS, HD]
    const float* __restrict__ k_scale,  // [Hkv, NB] (int8 pool only)
    const float* __restrict__ v_scale,  // [Hkv, NB] (int8 pool only)
    const int* __restrict__ tables,     // [B, MB]
    const int* __restrict__ offset,     // [B]: position of q[b, 0]
    T* __restrict__ out,                // [B, T, H * HD]
    int T_, int H, int Hkv, int NB, int MB, int window, float sm_scale,
    float softcap) {
  constexpr int E = HD / 32;            // elements of a row per lane
  constexpr int PAGE = BS * HD;         // elements of one page
  constexpr int VEC = 16 / sizeof(P);   // elements per 16-byte load
  static_assert(HD % 32 == 0, "HD must be a multiple of 32");
  static_assert(PAGE % VEC == 0, "a page must be whole 16-byte vectors");

  extern __shared__ __align__(16) unsigned char smem[];
  P* ks = reinterpret_cast<P*>(smem);
  P* vs = ks + PAGE;

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

  // chunk positions the block's rows cover (rows are g-major, t-minor)
  const int last = min(row0 + kWarps, nrows) - 1;
  int tlo = 0, thi = T_ - 1;
  if (row0 / T_ == last / T_) {
    tlo = row0 % T_;
    thi = last % T_;
  }
  // the page walk, with ops/ragged.py's two skip predicates: no page past
  // the causal frontier of the block's last row, none wholly below the
  // window of its first row
  const int jhi = min((off + thi) / BS, MB - 1);
  int jlo = 0;
  if (window > 0) {
    const int lo = off + tlo - window + 1;
    jlo = lo > 0 ? lo / BS : 0;
  }

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

  for (int j = jlo; j <= jhi; ++j) {
    const int blk = tables[b * MB + j];
    const uint4* kp = reinterpret_cast<const uint4*>(
        k_pool + ((size_t)kvh * NB + blk) * PAGE);
    const uint4* vp = reinterpret_cast<const uint4*>(
        v_pool + ((size_t)kvh * NB + blk) * PAGE);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (sizeof(P) == 1) {  // an int8 page carries its scales
      ksc = k_scale[kvh * NB + blk];
      vsc = v_scale[kvh * NB + blk];
    }
    for (int i = threadIdx.x; i < PAGE / VEC; i += kWarps * 32) {
      reinterpret_cast<uint4*>(ks)[i] = kp[i];
      reinterpret_cast<uint4*>(vs)[i] = vp[i];
    }
    __syncthreads();
    if (live) {
      const int kv0 = j * BS;
      float s[BS];
      float mpage = -INFINITY;
#pragma unroll
      for (int c = 0; c < BS; ++c) {
        const P* kr = ks + c * HD + lane * E;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qf[e] * kv_value<T>(kr[e], ksc);
        // xor butterfly: every lane ends with the same full sum
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (softcap > 0.f) d = tanhf(d / softcap) * softcap;
        const int kvpos = kv0 + c;
        const bool vis =
            kvpos <= qpos && (window <= 0 || kvpos > qpos - window);
        s[c] = vis ? d : -INFINITY;
        mpage = fmaxf(mpage, s[c]);
      }
      if (mpage > -INFINITY) {
        const float mnew = fmaxf(m, mpage);
        const float alpha = expf(m - mnew);  // 0 on the first visible page
        float psum = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
        for (int c = 0; c < BS; ++c) {
          // masked keys are skipped, not multiplied by 0: the null block
          // holds whatever dead rows scattered into it
          if (s[c] == -INFINITY) continue;
          const float p = expf(s[c] - mnew);
          psum += p;
          const P* vr = vs + c * HD + lane * E;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += p * kv_value<T>(vr[e], vsc);
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

template <typename T, typename P, int HD, int BS>
int launch(const RaggedArgs& a, cudaStream_t stream) {
  const int tiles = (a.H / a.Hkv * a.T + kWarps - 1) / kWarps;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(a.B * a.Hkv, tiles);
  const size_t smem = 2 * (size_t)BS * HD * sizeof(P);
  auto kernel = ragged_paged_attention_kernel<T, P, HD, BS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
      static_cast<const P*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.offset, static_cast<T*>(a.out), a.T, a.H, a.Hkv, a.NB, a.MB,
      a.window, a.sm_scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int HD>
int launch_bs(int BS, const RaggedArgs& a, cudaStream_t stream) {
  switch (BS) {
    case 8:
      return launch<T, P, HD, 8>(a, stream);
    case 16:
      return launch<T, P, HD, 16>(a, stream);
    case 32:
      return launch<T, P, HD, 32>(a, stream);
  }
  return -1;
}

template <typename T, typename P>
int launch_hd(int hd, int BS, const RaggedArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_bs<T, P, 64>(BS, a, stream);
    case 128:
      return launch_bs<T, P, 128>(BS, a, stream);
    case 256:
      return launch_bs<T, P, 256>(BS, a, stream);
  }
  return -1;
}

}  // namespace

// C entry point, bound with ctypes. dtype (of q, out): 0 = float32,
// 1 = bfloat16. k_scale/v_scale null: the pools are in q's type; both
// set: the pools are int8 with [Hkv, NB] f32 scales. Returns the
// cudaError_t of the launch (0 = launched), or -1 for a dtype / head_dim /
// block size this file was not built for.
extern "C" int b2b_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offset, void* out, int B, int T_, int H, int Hkv, int NB,
    int MB, int BS, int hd, int window, float sm_scale, float softcap,
    int dtype, void* stream) {
  const RaggedArgs a{q, k_pool, v_pool,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(offset), out, B, T_, H, Hkv, NB,
                     MB, window, sm_scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8_pool = k_scale != nullptr;
  if (int8_pool != (v_scale != nullptr)) return -1;
  if (dtype == 0)
    return int8_pool ? launch_hd<float, int8_t>(hd, BS, a, s)
                     : launch_hd<float, float>(hd, BS, a, s);
  if (dtype == 1)
    return int8_pool ? launch_hd<__nv_bfloat16, int8_t>(hd, BS, a, s)
                     : launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, BS, a, s);
  return -1;
}
