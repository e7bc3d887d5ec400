// The float32 page walk shared by the two paged decode kernels, Hopper
// sm_90a: paged_attention_splitk.cu (each split walks its share of a row's
// live pages) and paged_attention.cu (the legacy schedule walks all of
// them). Their bf16 instantiations walk with paged_warp_walk.cuh.
//
// One CTA of kThreads threads serves one (kv head h, sequence b) and one
// slice of at most kSliceRows of its G = Hq/Hkv query rows (GroupSlice:
// a kv head's rows in ceil(G / kSliceRows) slices, one CTA each, so any G
// runs; MQA's G 48 is six slices, each walking the row's K/V again).
// Each K/V page is loaded once into shared memory for the slice's rows;
// scores, the float32 online softmax (m, l) and the accumulator stay in
// shared memory and registers. Layouts: q (B,Hq,hd); k/v pages
// (P,bs,Hkv,hd), float32 or bfloat16; scale 1/sqrt(hd).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
constexpr int kSliceRows = 8;  // query rows a CTA holds: the 8 columns of the
                               // bf16 walk's mma.m16n8k16
constexpr int kMaxBs = 16;     // tokens per page
constexpr float kNegInf = -1e30f;

// A CTA's query rows: kv head h's group members g0 .. g0 + rows - 1, that
// is query heads h * G + g0 onwards. Grid index i = h * slices + s.
struct GroupSlice {
  int h, g0, rows;
};
__host__ __device__ inline int group_slices(int g) {
  return (g + kSliceRows - 1) / kSliceRows;
}
__device__ inline GroupSlice group_slice(int i, int g) {
  const int n = group_slices(g), s = i % n;
  return {i / n, s * kSliceRows, min(kSliceRows, g - s * kSliceRows)};
}

// accumulator elements a thread holds: element e = tid + j * kThreads of the
// (rows, HD) tile is row e / HD, column e % HD
template <int HD>
__host__ __device__ constexpr int acc_len() {
  return (kSliceRows * HD + kThreads - 1) / kThreads;
}

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

// Walk pages [first, end) of row b (``pages`` is the row's block table) in
// order with one running softmax for the slice ``sl``'s query rows; the
// caller has clipped end to the live pages (page i is live iff i*bs < ctx),
// so no page past the context is read. On return ``acc`` holds this
// thread's share of the unnormalised accumulator, and m, l the running max
// and sum of the slice's row tid / bs (the same on all of that row's bs
// lanes; meaningful where tid / bs < sl.rows).
template <typename T, int HD>
__device__ __forceinline__ void attend_pages(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pages, int b,
    GroupSlice sl, int hq, int hkv, int bs, int ctx, int first, int end,
    float scale, float& m, float& l, float (&acc)[acc_len<HD>()]) {
  constexpr int kRow = HD + 4;                      // keeps float4 rows aligned
  __shared__ __align__(16) float qs[kSliceRows][kRow];
  __shared__ __align__(16) float ks[kMaxBs][kRow];
  __shared__ __align__(16) float vs[kMaxBs][HD];
  __shared__ __align__(16) float ps[kSliceRows][kMaxBs];
  __shared__ float alpha_s[kSliceRows];

  const int h = sl.h, g_size = sl.rows;
  const int tid = threadIdx.x;
  const T* qrow = q + ((size_t)b * hq + (size_t)h * (hq / hkv) + sl.g0) * HD;
  for (int e = tid * 4; e < g_size * HD; e += kThreads * 4) {
    const int g = e / HD, d = e % HD;
    *reinterpret_cast<float4*>(&qs[g][d]) = load4(qrow + (size_t)g * HD + d);
  }

  // score owner: bs consecutive lanes hold one query row, lane t its key t;
  // bs divides 32, so a row's lanes share a warp and reduce by shuffles
  const int gi = tid / bs, t = tid % bs;
  const bool owner = gi < g_size;
  m = kNegInf;
  l = 0.f;
#pragma unroll
  for (int j = 0; j < acc_len<HD>(); ++j) acc[j] = 0.f;

  const size_t page_stride = (size_t)bs * hkv * HD;
  for (int i = first; i < end; ++i) {
    const size_t base = (size_t)pages[i] * page_stride + (size_t)h * HD;
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
    for (int j = 0; j < acc_len<HD>(); ++j) {
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
}

}  // namespace paged
