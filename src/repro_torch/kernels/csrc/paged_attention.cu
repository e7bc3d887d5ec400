// Legacy paged attention for one decode step, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _kernel): one running softmax per (sequence, kv
// head) over the row's pages on the grid (B, Hkv, nblk). Same contract as
// the split-K kernel: q (B,Hq,hd); k/v pages (P,bs,Hkv,hd) float32 or
// bfloat16; block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd)
// in q's dtype. Query head h reads kv head h / G, G = Hq/Hkv, any G >= 1;
// scale 1/sqrt(hd).
//
// What bounds it on the card: bytes. A decode step reads every live KV row
// once, about G flops per byte, far under the ~295 the H100 needs to be
// compute bound. The legacy contract is kept: one launch, grid
// (Hkv * ceil(G / 8), B), one CTA per (kv head, slice of at most 8 of its
// query rows, sequence), normalise and cast in the same launch, no partials
// in device memory and no merge launch (paged::GroupSlice: a group of up
// to 8 is one slice, the reference's (kv head, sequence); MQA's G 48 is
// six, each reading the row's K/V again, mostly from L2). So a long row is
// read by one SM a slice, and what matters is how many of its bytes are in
// flight at once and how few instructions each byte costs. The first version walked
// a row one 16-token page at a time through float32 shared memory, a full
// device-memory round trip per page. Now (paged_warp_walk.cuh, whose walk
// the split-K kernel shares; this kernel walks all of a row's tiles and
// normalises the CTA's state itself):
//   * the CTA's warps split the row's live tokens into contiguous shares
//     and walk them side by side, each with its own float32 online
//     softmax; the CTA merges the warps' states by log-sum-exp at the end;
//   * each warp keeps kStages - 1 tiles in flight with 16-byte cp.async
//     into a ring in shared memory while it multiplies the tile that has
//     landed; its block-table entries come 32 at a time by shuffles;
//   * bf16 runs both products on the tensor cores (mma.sync.m16n8k16, 16
//     tokens by the slice's up to 8 query rows), since an FMA body of every
//     lane (a full-hd dot product per (row, token) pair, then hd/32 columns of P.V)
//     issued too many instructions per byte to keep 32 pages a row in
//     flight: at B 32 four and eight warps a CTA took the same time;
//   * pages at or past the context are never copied and their table entries
//     never read; a row with ctx = 0 comes out as zeros.
// The CTA has kWarps = 4 warps: eight measured the same at B 8 and B 32
// (PERF.md). float32 keeps the first version's body, the split-K kernel's
// page walk (paged_attention_common.cuh: one page at a time through float32
// shared memory, FMA, 128 threads) and its normalising epilogue: its tests
// hold it to 2e-4, which no bf16 or TF32 product meets, and no timed path
// runs it.

#include "paged_attention_common.cuh"
#include "paged_warp_walk.cuh"

namespace {

constexpr int kWarps = 4;
static_assert(kWarps * 32 == paged::kThreads, "float32 walks with the CTA's threads");

// one CTA an SM is all the launch bounds promise: ptxas then takes the
// registers it needs instead of spilling to fit more CTAs (shared memory
// already holds an SM to one or two)
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, 1)
paged_warp_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ ctx_lens, T* __restrict__ out,
                        int hq, int hkv, int bs, int nblk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const paged::GroupSlice sl = paged::group_slice(blockIdx.x, hq / hkv);
  const int b = blockIdx.y;
  const int g_size = sl.rows;
  const int* pages = block_tables + (size_t)b * nblk;
  const int ctx = ctx_lens[b];
  // the slice's first output row
  T* orow = out + ((size_t)b * hq + (size_t)sl.h * (hq / hkv) + sl.g0) * HD;
  if constexpr (sizeof(T) == 2) {
    // walk every tile of the row, then normalise the CTA's state and cast
    __shared__ warp_walk::CtaState state;
    const int n_tok = min(max(ctx, 0), nblk * bs);
    warp_walk::walk_tiles<HD, kWarps>(q, k_pages, v_pages, pages, b, sl, hq, hkv, bs,
                                      n_tok, 0, (n_tok + warp_walk::kTile - 1) /
                                      warp_walk::kTile, scale, smem, state);
    const float* acc = reinterpret_cast<const float*>(smem);
    for (int e = threadIdx.x; e < g_size * HD; e += kWarps * 32)
      orow[e] = __float2bfloat16(__fdividef(acc[e], fmaxf(state.l[e / HD], 1e-20f)));
  } else {
    using paged::acc_len;
    __shared__ float l_s[paged::kSliceRows];
    const int tid = threadIdx.x;
    const int live = min(nblk, (max(ctx, 0) + bs - 1) / bs);
    float m, l, acc[acc_len<HD>()];
    paged::attend_pages<T, HD>(q, k_pages, v_pages, pages, b, sl, hq, hkv, bs, ctx, 0,
                               live, scale, m, l, acc);
    // normalise once; l_s hands each row's l to the threads that hold its
    // accumulator
    const int gi = tid / bs;
    if (gi < g_size && tid % bs == 0) l_s[gi] = l;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < acc_len<HD>(); ++j) {
      const int e = tid + j * paged::kThreads;
      const int g = e / HD, d = e % HD;
      if (g < g_size) orow[(size_t)g * HD + d] = acc[j] / fmaxf(l_s[g], 1e-20f);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const int* bt,
              const int* cl, void* out, int b, int hq, int hkv, int bs,
              int nblk, cudaStream_t st) {
  constexpr size_t smem = sizeof(T) == 2 ? warp_walk::smem_bytes<HD, kWarps>() : 0;
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_warp_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(hkv * paged::group_slices(hq / hkv), b);
  paged_warp_split_kernel<T, HD><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, cl, static_cast<T*>(out), hq, hkv, bs,
      nblk, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, void* out, int b, int hq, int hkv, int hd, int bs,
           int nblk, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st);
    case 32: return launch_hd<T, 32>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st);
    case 64: return launch_hd<T, 64>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st);
    case 128: return launch_hd<T, 128>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/paged_attention.py) has checked
// shapes, dtypes, contiguity, alignment, Hq divisible by Hkv, bs in
// {4, 8, 16} and hd in {16, 32, 64, 128}. Returns the cudaError_t of the
// launch.
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
