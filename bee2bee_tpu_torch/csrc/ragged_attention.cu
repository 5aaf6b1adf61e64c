// Ragged paged attention for Hopper (sm_90a): causal GQA attention of a
// [B, T] query chunk read straight from the paged KV pool through per-row
// block tables.
//
// Replaces the TPU kernel bee2bee_tpu/ops/ragged.py:_ragged_kernel (the
// bf16 pool; its int8 variant is not ported yet). Same function: queries
// fold to rows of (kv head, GQA group g major, chunk position t minor);
// per-row `offset`, one sliding `window` per call (0 = full causal),
// `sm_scale`, tanh `softcap` applied before the mask; pages past the causal
// frontier or wholly below the window are skipped; a row that sees nothing
// writes 0, never 0/0.
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
//         window and tables[b, j] itself and stages page j's K and V
//         [BS, HD] in shared memory;
//   score each warp computes its row's BS scores with the lanes split
//         over HD (HD / 32 elements a lane) and a shuffle reduction;
//   softmax online, in f32, with the accumulator in registers;
//   out   written straight into [B, T, H * HD].
// Left for later: splitting a row's pages across blocks and merging the
// partial softmaxes (flash-decoding) when B * Hkv is small next to the 132
// SMs, and wgmma tiles for long prefill chunks, where the scalar dot
// products below leave the tensor cores idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows per block, one warp each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD, int BS>
__global__ void __launch_bounds__(kWarps * 32)
ragged_paged_attention_kernel(
    const T* __restrict__ q,         // [B, T, H, HD]
    const T* __restrict__ k_pool,    // [Hkv, NB, BS, HD]
    const T* __restrict__ v_pool,    // [Hkv, NB, BS, HD]
    const int* __restrict__ tables,  // [B, MB]
    const int* __restrict__ offset,  // [B]: position of q[b, 0]
    T* __restrict__ out,             // [B, T, H * HD]
    int T_, int H, int Hkv, int NB, int MB, int window, float sm_scale,
    float softcap) {
  constexpr int E = HD / 32;            // elements of a row per lane
  constexpr int PAGE = BS * HD;         // elements of one page
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  static_assert(HD % 32 == 0, "HD must be a multiple of 32");
  static_assert(PAGE % VEC == 0, "a page must be whole 16-byte vectors");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + PAGE;

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
        const T* kr = ks + c * HD + lane * E;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qf[e] * to_float(kr[e]);
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

template <typename T, int HD, int BS>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* offset, void* out, int B, int T_,
           int H, int Hkv, int NB, int MB, int window, float sm_scale,
           float softcap, cudaStream_t stream) {
  const int tiles = (H / Hkv * T_ + kWarps - 1) / kWarps;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(B * Hkv, tiles);
  const size_t smem = 2 * (size_t)BS * HD * sizeof(T);
  auto kernel = ragged_paged_attention_kernel<T, HD, BS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(offset), static_cast<T*>(out), T_, H, Hkv, NB,
      MB, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bs(int BS, const void* q, const void* k_pool, const void* v_pool,
              const void* tables, const void* offset, void* out, int B,
              int T_, int H, int Hkv, int NB, int MB, int window,
              float sm_scale, float softcap, cudaStream_t stream) {
  switch (BS) {
    case 8:
      return launch<T, HD, 8>(q, k_pool, v_pool, tables, offset, out, B, T_,
                              H, Hkv, NB, MB, window, sm_scale, softcap,
                              stream);
    case 16:
      return launch<T, HD, 16>(q, k_pool, v_pool, tables, offset, out, B, T_,
                               H, Hkv, NB, MB, window, sm_scale, softcap,
                               stream);
    case 32:
      return launch<T, HD, 32>(q, k_pool, v_pool, tables, offset, out, B, T_,
                               H, Hkv, NB, MB, window, sm_scale, softcap,
                               stream);
  }
  return -1;
}

template <typename T>
int launch_hd(int hd, int BS, const void* q, const void* k_pool,
              const void* v_pool, const void* tables, const void* offset,
              void* out, int B, int T_, int H, int Hkv, int NB, int MB,
              int window, float sm_scale, float softcap,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_bs<T, 64>(BS, q, k_pool, v_pool, tables, offset, out, B,
                              T_, H, Hkv, NB, MB, window, sm_scale, softcap,
                              stream);
    case 128:
      return launch_bs<T, 128>(BS, q, k_pool, v_pool, tables, offset, out, B,
                               T_, H, Hkv, NB, MB, window, sm_scale, softcap,
                               stream);
    case 256:
      return launch_bs<T, 256>(BS, q, k_pool, v_pool, tables, offset, out, B,
                               T_, H, Hkv, NB, MB, window, sm_scale, softcap,
                               stream);
  }
  return -1;
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = launched), or -1 for a
// dtype / head_dim / block size this file was not built for.
extern "C" int b2b_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* offset, void* out, int B, int T_, int H, int Hkv, int NB,
    int MB, int BS, int hd, int window, float sm_scale, float softcap,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, BS, q, k_pool, v_pool, tables, offset, out, B,
                            T_, H, Hkv, NB, MB, window, sm_scale, softcap, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, BS, q, k_pool, v_pool, tables, offset,
                                    out, B, T_, H, Hkv, NB, MB, window,
                                    sm_scale, softcap, s);
  return -1;
}
