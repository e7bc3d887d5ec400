// Legacy serial-page paged attention for one decode step, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _kernel): one running softmax per (sequence, kv
// head) walks the row's pages in order on the grid (B, Hkv, nblk). Same
// contract as the split-K kernel: q (B,Hq,hd); k/v pages (P,bs,Hkv,hd)
// float32 or bfloat16; block_tables (B,nblk) int32; ctx_lens (B,) int32 ->
// (B,Hq,hd) in q's dtype. Query head h reads kv head h / G, G = Hq/Hkv;
// scale 1/sqrt(hd).
//
// What bounds it on the card: bytes, as for split-K (every live KV row is
// read once, about G flops per byte). The schedule is the TPU kernel's: one
// CTA per (kv head, sequence) carries one float32 (m, l, acc) for its G
// query rows over the row's live pages (page i is live iff i < nblk and
// i*bs < ctx), one page after the other; pages at or past ctx are never
// read, so table entries past the context may hold anything. The output is
// acc / max(l, 1e-20), cast in the same launch: a row with ctx = 0 comes
// out as zeros. There is no split and no merge launch, so a long row runs
// on one SM and B*Hkv CTAs must fill the card by themselves: at B 8,
// Hkv 8 that is 64 CTAs on 132 SMs. That is the legacy schedule, kept as
// the TPU kernel has it; split-K (paged_attention_splitk.cu) is the fast
// one. Inside a CTA the page loop is the split-K kernel's
// (paged_attention_common.cuh): each K/V page is loaded once into shared
// memory for all G query rows, float32 FMA.

#include "paged_attention_common.cuh"

namespace {

using paged::acc_len;
using paged::kMaxG;
using paged::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ ctx_lens, T* __restrict__ out,
                       int hq, int hkv, int bs, int nblk, float scale) {
  __shared__ float l_s[kMaxG];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g_size = hq / hkv;
  const int tid = threadIdx.x;
  const int ctx = ctx_lens[b];

  const int live = min(nblk, (max(ctx, 0) + bs - 1) / bs);
  float m, l, acc[acc_len<HD>()];
  paged::attend_pages<T, HD>(q, k_pages, v_pages, block_tables + (size_t)b * nblk,
                             b, h, hq, hkv, bs, ctx, 0, live, scale, m, l, acc);

  // epilogue: normalise once and cast; l_s hands each row's l to the
  // threads that hold its accumulator
  const int gi = tid / bs;
  if (gi < g_size && tid % bs == 0) l_s[gi] = l;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < acc_len<HD>(); ++j) {
    const int e = tid + j * kThreads;
    const int g = e / HD, d = e % HD;
    if (g < g_size)
      paged::store(out + ((size_t)b * hq + (size_t)h * g_size + g) * HD + d,
                   acc[j] / fmaxf(l_s[g], 1e-20f));
  }
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, const int* bt,
               const int* cl, void* out, int b, int hq, int hkv, int bs,
               int nblk, cudaStream_t st) {
  const dim3 grid(hkv, b);
  paged_attention_kernel<T, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, cl, static_cast<T*>(out), hq, hkv, bs,
      nblk, 1.0f / sqrtf(static_cast<float>(HD)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, void* out, int b, int hq, int hkv, int hd, int bs,
           int nblk, cudaStream_t st) {
  switch (hd) {
    case 16: launch_hd<T, 16>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st); break;
    case 32: launch_hd<T, 32>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st); break;
    case 64: launch_hd<T, 64>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st); break;
    case 128: launch_hd<T, 128>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/paged_attention.py) has checked
// shapes, dtypes, contiguity, alignment, G <= 8, bs in {4, 8, 16} and
// hd in {16, 32, 64, 128}. Returns the cudaError_t of the launch.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* block_tables,
                               const void* ctx_lens, void* out, int b, int hq,
                               int hkv, int hd, int bs, int nblk, int is_bf16,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto bt = static_cast<const int*>(block_tables);
  const auto cl = static_cast<const int*>(ctx_lens);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, cl, out, b, hq, hkv,
                                 hd, bs, nblk, st);
  return launch<float>(q, k_pages, v_pages, bt, cl, out, b, hq, hkv, hd, bs,
                       nblk, st);
}
