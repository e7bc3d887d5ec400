// Chunked-prefill causal attention with a fused epilogue, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill.py:
// chunked_prefill_attention (body _kernel). Same contract: q (Sc,Hq,hd) at
// absolute positions ctx+i; k/v (T,Hkv,hd), float32 or bfloat16; scalar ctx
// -> (Sc,Hq,hd) in q's dtype. Query row i sees key j iff j <= ctx+i (and
// j < T); query head h reads kv head h / G, G = Hq/Hkv; scale 1/sqrt(hd).
//
// What bounds it on the card: a chunk does 4*hd flops per visible (query
// head, key) pair and reads (ctx+Sc)*Hkv*hd*2*itemsize of K/V, about G*Sc
// flops per byte once the prefix is long: 256 at qwen3-4b's G = 4 and the
// engine's Sc = 64, near the ~295 at which the H100's bf16 tensor cores
// stop waiting for memory. This simple version runs on the float32 FMA
// units instead, so operations bound it. The design keeps the work to what
// causality needs and everything but q, K/V and the output on chip:
//   * one CTA per (query head, tile of 16 query rows); it walks key tiles of
//     32 only up to the causal frontier ctx + last row of the tile, so
//     blocks above the diagonal are never read;
//   * tiles wholly below the diagonal take a mask-free path; only the tiles
//     that straddle it (or the ragged end of T) evaluate the mask;
//   * float32 online softmax: a warp owns 4 query rows, a lane one key of
//     the tile, max and sum by warp shuffles; the accumulator lives in
//     registers, the tile in shared memory;
//   * fused epilogue: normalise by max(l, 1e-20), cast, and store only rows
//     < Sc. Shapes that do not divide the tiles are masked in the loads and
//     the store, never padded by copies, so there are no padded rows to
//     zero or slice off.
// wgmma, TMA and reading the pages through the block table in the kernel
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBQ = 16;         // query rows per CTA
constexpr int kBK = 32;         // keys per tile: one per lane
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
chunked_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sc,
                       int t_len, int hq, int hkv, int ctx, float scale) {
  constexpr int kRow = HD + 4;                      // keeps float4 rows aligned
  constexpr int kAcc = kBQ * HD / kThreads;         // output elements per thread
  __shared__ __align__(16) float qs[kBQ][kRow];
  __shared__ __align__(16) float ks[kBK][kRow];
  __shared__ __align__(16) float vs[kBK][HD];
  __shared__ __align__(16) float ps[kBQ][kBK];
  __shared__ float alpha_s[kBQ];
  __shared__ float l_s[kBQ];

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid * 4; e < kBQ * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    *reinterpret_cast<float4*>(&qs[r][d]) =
        row < sc ? load4(q + ((size_t)row * hq + h) * HD + d)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];           // rows warp + 4*i, per lane copy
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  const int last_row = min(q0 + kBQ, sc) - 1;
  const int k_end = min(t_len, ctx + last_row + 1);  // causal frontier of the tile
  const int n_tiles = (k_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                                // previous tile fully consumed
    for (int e = tid * 4; e < kBK * HD; e += kThreads * 4) {
      const int c = e / HD, d = e % HD;
      const int j = k0 + c;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < t_len) {
        const size_t off = ((size_t)j * hkv + kvh) * HD + d;
        kv = load4(k + off);
        vv = load4(v + off);
      }
      *reinterpret_cast<float4*>(&ks[c][d]) = kv;
      *reinterpret_cast<float4*>(&vs[c][d]) = vv;
    }
    __syncthreads();

    // mask-free iff every key of the tile exists and is visible to the
    // tile's first row (hence to all of its rows)
    const bool full = (k0 + kBK - 1 <= ctx + q0) && (k0 + kBK <= t_len);
    float dot[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 c = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[warp + 4 * i][d]);
        dot[i] += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + 4 * i;
      const bool valid = full || (j < t_len && j <= ctx + q0 + r);
      const float s = valid ? dot[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      ps[r][lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int e = tid + a * kThreads;
      const int r = e / HD, d = e % HD;
      float o = acc[a] * alpha_s[r];
#pragma unroll 4
      for (int c = 0; c < kBK; c += 4) {
        const float4 pp = *reinterpret_cast<const float4*>(&ps[r][c]);
        o += pp.x * vs[c][d] + pp.y * vs[c + 1][d] + pp.z * vs[c + 2][d]
           + pp.w * vs[c + 3][d];
      }
      acc[a] = o;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + 4 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int e = tid + a * kThreads;
    const int r = e / HD, d = e % HD;
    const int row = q0 + r;
    if (row < sc)
      store(out + ((size_t)row * hq + h) * HD + d, acc[a] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int sc,
            int t_len, int hq, int hkv, int ctx, cudaStream_t st) {
  const dim3 grid(hq, (sc + kBQ - 1) / kBQ);
  chunked_prefill_kernel<T, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sc, t_len, hq, hkv, ctx,
      1.0f / sqrtf(static_cast<float>(HD)));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int sc,
             int t_len, int hq, int hkv, int hd, int ctx, cudaStream_t st) {
  switch (hd) {
    case 16: launch<T, 16>(q, k, v, out, sc, t_len, hq, hkv, ctx, st); break;
    case 32: launch<T, 32>(q, k, v, out, sc, t_len, hq, hkv, ctx, st); break;
    case 64: launch<T, 64>(q, k, v, out, sc, t_len, hq, hkv, ctx, st); break;
    case 128: launch<T, 128>(q, k, v, out, sc, t_len, hq, hkv, ctx, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/chunked_prefill.py) has checked
// shapes, dtypes, contiguity, alignment and hd in {16, 32, 64, 128}.
// Returns the cudaError_t of the launch.
extern "C" int chunked_prefill_attention(const void* q, const void* k,
                                         const void* v, void* out, int sc,
                                         int t_len, int hq, int hkv, int hd,
                                         int ctx, int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, sc, t_len, hq, hkv, hd, ctx, st);
  return dispatch<float>(q, k, v, out, sc, t_len, hq, hkv, hd, ctx, st);
}
