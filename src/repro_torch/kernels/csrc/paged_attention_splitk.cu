// Split-K (flash-decoding) paged attention for one decode step, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_splitk (body _splitk_kernel, LSE merge at the end of the
// wrapper). Same contract: q (B,Hq,hd); k/v pages (P,bs,Hkv,hd) float32 or
// bfloat16; block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd) in
// q's dtype. Query head h reads kv head h / G, G = Hq/Hkv, any G >= 1;
// scale 1/sqrt(hd).
//
// What bounds it on the card: bytes. A decode step reads every live KV row
// once, ctx*Hkv*hd*2*itemsize per sequence per layer, and does 4*hd flops per
// (query head, key) pair: about G flops per byte, far under the ~295 the
// H100 needs to be compute bound. So what matters is how many of a row's
// bytes are in flight at once, how few instructions each byte costs, and
// that nothing but the KV crosses device memory (no partials, no second
// launch to merge them):
//   * one launch, grid (nsplit, Hkv * ceil(G / 8), B): the nsplit CTAs of
//     one (sequence, kv head, slice of at most 8 of its query rows;
//     paged::GroupSlice) form one thread-block cluster (cudaLaunchKernelEx,
//     at most 8 CTAs, the portable cluster size; one split launches without a
//     cluster, whose launch cost a microsecond at batch 8). Split s walks
//     its share of the row's live 16-token tiles (a row's tiles in nsplit
//     equal contiguous shares, so a short context spreads over every split
//     and a split past the live tiles walks nothing);
//   * bf16 walks with the legacy kernel's warp-split tensor-core walk
//     (paged_warp_walk.cuh: 4 warps, each with a three-tile cp.async ring,
//     S^T = K Q^T and O^T += V^T P^T on mma.m16n8k16, table entries by
//     shuffles), which leaves the CTA's unnormalised (m, l, acc) in shared
//     memory; float32 walks with paged_attention_common.cuh's FMA body, as
//     the legacy kernel's float32 does (its tests hold it to 2e-4, which no
//     bf16 or TF32 product meets);
//   * after cluster.sync() each CTA reads every split's (m, l) and acc
//     through distributed shared memory (map_shared_rank), merges them by
//     log-sum-exp, normalises once by max(l, 1e-20) and stores its share of
//     the slice's rows x hd outputs; a second cluster.sync() keeps every
//     CTA's shared memory alive until its peers have read it. No partial
//     touches device memory. A split without live tiles contributes (acc 0,
//     m -1e30, l 0), the identity of the merge; a row with ctx = 0 comes out
//     as zeros.
// The wrapper picks the number of splits: enough tiles per warp for its
// ring, about two waves of resident CTAs, at most a cluster (8); at the
// serve's table width that is one split.

#include <cooperative_groups.h>

#include "paged_attention_common.cuh"
#include "paged_warp_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
// the portable cluster size (16-CTA clusters, non-portable, were no faster
// at long context in a trial)
constexpr int kMaxSplits = 8;
static_assert(kWarps * 32 == paged::kThreads, "float32 walks with the CTA's threads");

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) == 2 ? warp_walk::smem_bytes<HD, kWarps>()
                        : (size_t)paged::kSliceRows * HD * sizeof(float);
}

// one CTA an SM is all the launch bounds promise, as for the legacy kernel:
// ptxas takes the registers the walk needs instead of spilling
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, 1)
splitk_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ ctx_lens, T* __restrict__ out,
                      int hq, int hkv, int bs, int nblk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ warp_walk::CtaState state;
  __shared__ float weight[kMaxSplits][paged::kSliceRows];  // exp(m_s - max_s m_s)
  __shared__ float inv_l[paged::kSliceRows];
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = gridDim.x;            // grid x = cluster x
  const bool clustered = nsplit > 1;       // one split launches without a cluster
  const int split = clustered ? (int)cluster.block_rank() : 0;
  const paged::GroupSlice sl = paged::group_slice(blockIdx.y, hq / hkv);
  const int b = blockIdx.z;
  const int g_size = sl.rows;
  const int tid = threadIdx.x;
  const int ctx = ctx_lens[b];
  const int* pages = block_tables + (size_t)b * nblk;
  float* acc = reinterpret_cast<float*>(smem);         // (kSliceRows, HD), this split's

  if constexpr (sizeof(T) == 2) {
    const int n_tok = min(max(ctx, 0), nblk * bs);
    const int tiles = (n_tok + warp_walk::kTile - 1) / warp_walk::kTile;
    const int share = (tiles + nsplit - 1) / nsplit;
    const int t0 = min(split * share, tiles);
    warp_walk::walk_tiles<HD, kWarps>(q, k_pages, v_pages, pages, b, sl, hq, hkv, bs,
                                      n_tok, t0, min(t0 + share, tiles), scale, smem,
                                      state);
  } else {
    // this split's share of the row's live pages
    using paged::acc_len;
    const int live = min(nblk, (max(ctx, 0) + bs - 1) / bs);
    const int share = (live + nsplit - 1) / nsplit;
    const int first = min(split * share, live);
    float m, l, a[acc_len<HD>()];
    paged::attend_pages<T, HD>(q, k_pages, v_pages, pages, b, sl, hq, hkv, bs, ctx, first,
                               min(first + share, live), scale, m, l, a);
#pragma unroll
    for (int j = 0; j < acc_len<HD>(); ++j) {
      const int e = tid + j * paged::kThreads;
      if (e < g_size * HD) acc[e] = a[j];
    }
    const int gi = tid / bs;
    if (gi < g_size && tid % bs == 0) {
      state.m[gi] = m;
      state.l[gi] = l;
    }
  }

  // every split's state is in place
  if (clustered) cluster.sync(); else __syncthreads();
  auto peer_state = [&](int s) {
    return clustered ? cluster.map_shared_rank(&state, s) : &state;
  };
  auto peer_acc = [&](int s) { return clustered ? cluster.map_shared_rank(acc, s) : acc; };
  if (tid < g_size) {
    float mx = warp_walk::kNegInf;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, peer_state(s)->m[tid]);
    float lsum = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const warp_walk::CtaState* peer = peer_state(s);
      const float w = expf(peer->m[tid] - mx);
      weight[s][tid] = w;
      lsum += w * peer->l[tid];
    }
    inv_l[tid] = __fdividef(1.f, fmaxf(lsum, 1e-20f));
  }
  __syncthreads();
  // this CTA's share of the slice's rows x HD outputs
  T* orow = out + ((size_t)b * hq + (size_t)sl.h * (hq / hkv) + sl.g0) * HD;
  for (int e = split * paged::kThreads + tid; e < g_size * HD;
       e += nsplit * paged::kThreads) {
    const int g = e / HD;
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s) o += weight[s][g] * peer_acc(s)[e];
    paged::store(orow + e, o * inv_l[g]);
  }
  if (clustered) cluster.sync();           // peers are done reading this CTA
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const int* bt, const int* cl,
              void* out, int b, int hq, int hkv, int bs, int nblk, int nsplit,
              cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        splitk_cluster_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, hkv * paged::group_slices(hq / hkv), b);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, splitk_cluster_kernel<T, HD>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), bt, cl, static_cast<T*>(out),
      hq, hkv, bs, nblk, 1.0f / sqrtf(static_cast<float>(HD)));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bt, const int* cl,
           void* out, int b, int hq, int hkv, int hd, int bs, int nblk, int nsplit,
           cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, nsplit, st);
    case 32: return launch_hd<T, 32>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, nsplit, st);
    case 64: return launch_hd<T, 64>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, nsplit, st);
    case 128: return launch_hd<T, 128>(q, k, v, bt, cl, out, b, hq, hkv, bs, nblk, nsplit, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/paged_attention.py) has checked
// shapes, dtypes, contiguity, alignment, Hq divisible by Hkv, bs in
// {4, 8, 16}, hd in {16, 32, 64, 128} and 1 <= nsplit <= 8. Returns the
// cudaError_t of the launch.
extern "C" int paged_attention_splitk(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* ctx_lens, void* out, int b, int hq,
                                      int hkv, int hd, int bs, int nblk, int nsplit,
                                      int is_bf16, void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto bt = static_cast<const int*>(block_tables);
  const auto cl = static_cast<const int*>(ctx_lens);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, cl, out, b, hq, hkv, hd, bs,
                                 nblk, nsplit, st);
  return launch<float>(q, k_pages, v_pages, bt, cl, out, b, hq, hkv, hd, bs, nblk,
                       nsplit, st);
}
