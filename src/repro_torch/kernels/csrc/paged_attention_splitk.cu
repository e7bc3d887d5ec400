// Split-K (flash-decoding) paged attention for one decode step, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_splitk (body _splitk_kernel, LSE merge at the end of the
// wrapper). Same contract: q (B,Hq,hd); k/v pages (P,bs,Hkv,hd) float32 or
// bfloat16; block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd) in
// q's dtype. Query head h reads kv head h / G, G = Hq/Hkv; scale 1/sqrt(hd).
//
// What bounds it on the card: bytes. A decode step reads every live KV row
// once, ctx*Hkv*hd*2*itemsize per sequence per layer, and does 4*hd flops per
// (query head, key) pair: about G flops per byte, far under the ~295 the
// H100 needs to be compute bound. The design therefore aims at reading each
// page once and keeping everything else on chip:
//   * one CTA per (split, kv head, sequence); it reads its own block-table
//     entries. A row's live pages (page i is live iff i < nblk and
//     i*bs < ctx) are divided evenly among the splits, so ragged batches pay
//     for their own context and a short context still spreads over every
//     split instead of landing in the first one;
//   * each K/V page is loaded once into shared memory for all G query rows;
//   * scores, the float32 online softmax (m, l) and the accumulator stay in
//     shared memory and registers; only the unnormalised partial
//     (acc, m, l) of each split goes to device memory, in float32;
//   * a second small launch merges the splits by log-sum-exp, divides once
//     by max(l, 1e-20) and casts. A split without live pages contributes
//     (0, -1e30, 0), the identity of the merge; a row with ctx = 0 (a padded
//     decode row) comes out as exact zeros, finite.
// Splitting the pages keeps the card busy when B*Hkv CTAs alone would not
// fill its 132 SMs (the wrapper picks the number of splits).
// Simple first version: float32 FMA from shared memory; wgmma, TMA and
// warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;     // query rows per kv head
constexpr int kMaxBs = 16;   // tokens per page
constexpr float kNegInf = -1e30f;

// four consecutive elements as float (16-byte aligned for float32, 8-byte
// for bfloat16: a bfloat16 is the top half of the float32 with its bits)
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
splitk_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ ctx_lens,
                      float* __restrict__ o_part,   // (B, Hkv, nsplit, G, HD)
                      float* __restrict__ m_part,   // (B, Hkv, nsplit, G)
                      float* __restrict__ l_part,   // (B, Hkv, nsplit, G)
                      int hq, int hkv, int bs, int nblk, float scale) {
  constexpr int kRow = HD + 4;                      // keeps float4 rows aligned
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  __shared__ __align__(16) float qs[kMaxG][kRow];
  __shared__ __align__(16) float ks[kMaxBs][kRow];
  __shared__ __align__(16) float vs[kMaxBs][HD];
  __shared__ __align__(16) float ps[kMaxG][kMaxBs];
  __shared__ float alpha_s[kMaxG];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int g_size = hq / hkv;
  const int tid = threadIdx.x;
  const int ctx = ctx_lens[b];

  for (int e = tid * 4; e < g_size * HD; e += kThreads * 4) {
    const int g = e / HD, d = e % HD;
    *reinterpret_cast<float4*>(&qs[g][d]) =
        load4(q + ((size_t)b * hq + (size_t)h * g_size + g) * HD + d);
  }

  // score owner: bs consecutive lanes hold one query row, lane t its key t;
  // bs divides 32, so a row's lanes share a warp and reduce by shuffles
  const int gi = tid / bs, t = tid % bs;
  const bool owner = gi < g_size;
  float m = kNegInf, l = 0.f;                       // identical across the row's lanes
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  // this row's live pages, in equal shares of consecutive pages per split
  const int live = min(nblk, (max(ctx, 0) + bs - 1) / bs);
  const int share = (live + nsplit - 1) / nsplit;
  const int first = split * share;
  const int live_end = min(first + share, live);
  const size_t page_stride = (size_t)bs * hkv * HD;
  for (int i = first; i < live_end; ++i) {
    const size_t base = (size_t)block_tables[(size_t)b * nblk + i] * page_stride
                        + (size_t)h * HD;
    __syncthreads();                                // previous page fully consumed
    for (int e = tid * 4; e < bs * HD; e += kThreads * 4) {
      const int tt = e / HD, d = e % HD;
      const size_t off = base + (size_t)tt * hkv * HD + d;
      *reinterpret_cast<float4*>(&ks[tt][d]) = load4(k_pages + off);
      *reinterpret_cast<float4*>(&vs[tt][d]) = load4(v_pages + off);
    }
    __syncthreads();

    const bool valid = owner && (i * bs + t < ctx);
    float s = kNegInf;
    if (valid) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[gi][d]);
        const float4 c = *reinterpret_cast<const float4*>(&ks[t][d]);
        dot += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
      s = dot * scale;
    }
    float mx = s;
    for (int off = bs >> 1; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, bs));
    const float m_new = fmaxf(m, mx);
    const float p = valid ? expf(s - m_new) : 0.f;
    float sum = p;
    for (int off = bs >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off, bs);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    if (owner) {
      ps[gi][t] = p;
      if (t == 0) alpha_s[gi] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int e = tid + j * kThreads;
      const int g = e / HD, d = e % HD;
      if (g < g_size) {
        float a = acc[j] * alpha_s[g];
        for (int tt = 0; tt < bs; tt += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(&ps[g][tt]);
          a += pp.x * vs[tt][d] + pp.y * vs[tt + 1][d]
             + pp.z * vs[tt + 2][d] + pp.w * vs[tt + 3][d];
        }
        acc[j] = a;
      }
    }
  }

  const size_t part = ((size_t)b * hkv + h) * nsplit + split;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = tid + j * kThreads;
    const int g = e / HD, d = e % HD;
    if (g < g_size) o_part[(part * g_size + g) * HD + d] = acc[j];
  }
  if (owner && t == 0) {
    m_part[part * g_size + gi] = m;
    l_part[part * g_size + gi] = l;
  }
}

// one thread per output element: log-sum-exp merge of the split partials
template <typename T>
__global__ void splitk_merge_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ m_part,
                                    const float* __restrict__ l_part,
                                    T* __restrict__ out, int total, int hq,
                                    int hkv, int hd, int nsplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = idx % hd, row = idx / hd;
  const int b = row / hq, qh = row % hq;
  const int g_size = hq / hkv, h = qh / g_size, g = qh % g_size;
  const size_t base = ((size_t)b * hkv + h) * nsplit;
  float m_max = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    m_max = fmaxf(m_max, m_part[(base + s) * g_size + g]);
  float l_tot = 0.f, o_tot = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t r = (base + s) * g_size + g;
    const float w = expf(m_part[r] - m_max);
    l_tot += w * l_part[r];
    o_tot += w * o_part[r * hd + d];
  }
  store(out + idx, o_tot / fmaxf(l_tot, 1e-20f));
}

template <typename T, int HD>
void launch_partial(const void* q, const void* k, const void* v, const int* bt,
                    const int* cl, float* o, float* m, float* l, int b, int hq,
                    int hkv, int bs, int nblk, int nsplit, cudaStream_t st) {
  const dim3 grid(nsplit, hkv, b);
  splitk_partial_kernel<T, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, cl, o, m, l, hq, hkv, bs, nblk,
      1.0f / sqrtf(static_cast<float>(HD)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, float* o, float* m, float* l, void* out, int b,
           int hq, int hkv, int hd, int bs, int nblk, int nsplit,
           cudaStream_t st) {
  switch (hd) {
    case 16: launch_partial<T, 16>(q, k, v, bt, cl, o, m, l, b, hq, hkv, bs, nblk, nsplit, st); break;
    case 32: launch_partial<T, 32>(q, k, v, bt, cl, o, m, l, b, hq, hkv, bs, nblk, nsplit, st); break;
    case 64: launch_partial<T, 64>(q, k, v, bt, cl, o, m, l, b, hq, hkv, bs, nblk, nsplit, st); break;
    case 128: launch_partial<T, 128>(q, k, v, bt, cl, o, m, l, b, hq, hkv, bs, nblk, nsplit, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = b * hq * hd;
  splitk_merge_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      o, m, l, static_cast<T*>(out), total, hq, hkv, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/paged_attention.py) has checked
// shapes, dtypes, contiguity, alignment, G <= 8, bs in {4, 8, 16} and
// hd in {16, 32, 64, 128}. Returns the cudaError_t of the two launches.
extern "C" int paged_attention_splitk(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* ctx_lens, void* o_part,
                                      void* m_part, void* l_part, void* out,
                                      int b, int hq, int hkv, int hd, int bs,
                                      int nblk, int nsplit,
                                      int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto bt = static_cast<const int*>(block_tables);
  const auto cl = static_cast<const int*>(ctx_lens);
  const auto o = static_cast<float*>(o_part);
  const auto m = static_cast<float*>(m_part);
  const auto l = static_cast<float*>(l_part);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, cl, o, m, l, out, b,
                                 hq, hkv, hd, bs, nblk, nsplit, st);
  return launch<float>(q, k_pages, v_pages, bt, cl, o, m, l, out, b, hq, hkv,
                       hd, bs, nblk, nsplit, st);
}
