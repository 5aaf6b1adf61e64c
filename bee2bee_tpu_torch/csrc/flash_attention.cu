// Flash attention over contiguous K/V for Hopper (sm_90a): tiled causal or
// non-causal GQA attention of q [B, T, H, HD] over k, v [B, S, Hkv, HD].
//
// Replaces the TPU kernel bee2bee_tpu/ops/flash.py:_flash_kernel. Same
// function: per-row offset (query t of row b sits at offset[b] + t), GQA
// head h reads kv head h / (H / Hkv), key tiles above the diagonal are
// skipped (here through the loop bound), a row that sees nothing (offset
// -1 at T = 1) writes 0. The JAX wrapper transposes K/V to head-major and
// zero-pads S to the block; this kernel reads [B, S, Hkv, HD] in place (a
// key row of one head is HD contiguous elements, so 16-byte loads still
// work) and treats keys past S as absent. Inside the contract
// offset + T <= S the two agree; past it the JAX kernel attends the
// padding's zeros.
//
// The design is the ragged kernel's (ragged_attention.cu) with another
// way to address keys:
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
// What bounds it: scalar dot products, no tensor cores (wgmma tiles are
// the redesign), and at long T each block walks up to S / kTile tiles for
// only kWarps rows.

#include "attention.cuh"

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
    case 128:
      return launch<T, 128>(a, stream);
    case 256:
      return launch<T, 256>(a, stream);
  }
  return -1;
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
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
