// A warp-split walk over a range of one row's 16-token tiles with the pages
// in flight, Hopper sm_90a: the bf16 decode attention of one (kv head h,
// sequence b) and one slice of at most 8 of its G query rows in one CTA
// (paged::GroupSlice; a group of G > 8, MQA's 48, is ceil(G / 8) CTAs,
// each walking the row's K/V again, mostly from L2). Both paged decode
// kernels walk with it: the legacy kernel (paged_attention.cu) over all of
// a row's tiles, split-K (paged_attention_splitk.cu) over one split's
// share. Their float32 instantiations walk with paged_attention_common.cuh
// instead.
//
// The CTA's kWarps warps divide the range's live tokens (those < ctx, in the
// pages the table lists; a page at or past the context is never touched)
// into contiguous shares of whole tiles of 16 tokens. Each warp walks its
// share with its own float32 online softmax (m, l, acc) for the slice's
// query rows, and the CTA combines the warps' states by log-sum-exp in
// shared memory at the end. The walk leaves the CTA's state unnormalised:
// acc (rows, HD) float32 at the start of the dynamic shared memory and
// (m, l) per query row in a CtaState, so the caller normalises it (legacy)
// or merges it with other CTAs' states first (split-K). Per warp:
//   * a ring of kStages tiles (K and V) in shared memory, filled with
//     16-byte cp.async.cg, so the next kStages - 1 tiles are in flight while
//     one is multiplied; rows are padded by 16 bytes, so lanes reading
//     different tokens' rows hit different banks. Only the warp touches its
//     ring, so the walk synchronises with __syncwarp, never the whole CTA;
//   * the warp's block-table entries are read 32 at a time into the lanes'
//     registers and handed out by shuffles, so no page copy waits on a
//     dependent table load;
//   * both products on the tensor cores, with the 16 tokens of a tile as
//     the 16 rows of mma.m16n8k16 and the slice's <= 8 query rows as its
//     8 columns: S^T = K Q^T (K by ldmatrix, Q^T held in registers), the
//     online softmax in float32 on the S^T fragments, P^T moved into B
//     fragments by movmatrix.trans and cast to bf16 (as the plain version
//     casts the probabilities to q.dtype), O^T += V^T P^T (V by
//     ldmatrix.trans). A tile of 16 tokens is 16 / bs pages.
// No copy is issued, and no table entry read, for a page at or past the
// context, so table entries past the context may point anywhere; the rows
// of a tile past the live tokens (ctx, or the table's nblk * bs if that is
// less) are zero-filled without a load and masked. A warp or CTA without
// tokens leaves (acc 0, m -1e30, l 0), the identity of the merge, and a row
// with ctx = 0 comes out as zeros. Layouts: q (B,Hq,hd); k/v pages
// (P,bs,Hkv,hd); scale 1/sqrt(hd).

#pragma once

#include "mma_ptx.cuh"
#include "paged_attention_common.cuh"

namespace warp_walk {

using bf16 = __nv_bfloat16;
using namespace ptx;
using paged::GroupSlice;
constexpr int kRows = paged::kSliceRows;   // query rows a CTA: mma's 8 columns
constexpr int kTile = 16;      // tokens per tile
constexpr int kStages = 3;     // tiles in a warp's ring
constexpr float kNegInf = -1e30f;

template <int HD>
__host__ __device__ constexpr int row_elems() { return HD + 8; }   // 16-byte pad per row

// dynamic shared memory: the rings, reused for the warps' accumulators
template <int HD, int kWarps>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t ring = (size_t)kWarps * kStages * 2 * kTile * row_elems<HD>() * sizeof(bf16);
  constexpr size_t merge = (size_t)kWarps * kRows * HD * sizeof(float);
  return ring > merge ? ring : merge;
}

// The block-table entries of a warp's n pages, 32 at a time in the lanes'
// registers: lane j holds entry base + j. table_advance (warp-uniform, i
// growing by at most 32 a call) makes page i's window current; a shuffle
// then hands out any entry of the window. Entries at or past n are never
// read.
__device__ __forceinline__ int table_first(const int* pages, int n, int lane) {
  return lane < n ? pages[lane] : 0;
}
__device__ __forceinline__ void table_advance(const int* pages, int n, int i, int lane,
                                              int& base, int& mine) {
  if (i - base >= 32) {
    base += 32;
    mine = base + lane < n ? pages[base + lane] : 0;
  }
}

template <int kWarps>
struct MergeState {
  float m[kWarps][kRows];
  float l[kWarps][kRows];
};

// The CTA's state after a walk: (m, l) per query row of the slice; acc
// lives at the start of the dynamic shared memory as (kRows, HD) float32.
struct CtaState {
  float m[kRows];
  float l[kRows];
};

// Combine the warps' (m, l, acc) by log-sum-exp into the CTA's state, acc
// in place over warp 0's slot of acc_s ((kWarps, kRows, HD) float: each
// element is read and written by one thread only).
template <int HD, int kWarps>
__device__ __forceinline__ void combine(const MergeState<kWarps>& st, float* acc_s,
                                        CtaState& out, int g_size) {
  for (int e = threadIdx.x; e < g_size * HD; e += kWarps * 32) {
    const int g = e / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, st.m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(st.m[w][g] - mx);
      lsum += st.l[w][g] * f;
      o += acc_s[(size_t)w * kRows * HD + e] * f;
    }
    acc_s[e] = o;
    if (e % HD == 0) {
      out.m[g] = mx;
      out.l[g] = lsum;
    }
  }
}

// the transpose of an 8x8 b16 matrix fragment
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// max / sum over the 8 lanes that share lane % 4 (the 8 row groups)
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * grp + quad): the S^T and
// O^T accumulators hold row grp (token, or hd column) in c[0..1] and row
// grp + 8 in c[2..3], at columns (query rows) 2 quad and 2 quad + 1. So a
// lane's m and l are those of query rows 2 quad + {0, 1}, the same columns
// as its accumulator entries.
//
// Walks tiles [t_begin, t_end) of row b's n_tok live tokens (n_tok =
// min(ctx, nblk * bs); tile t holds tokens 16 t .. 16 t + 15) for the query
// rows of slice ``sl`` and leaves the CTA's unnormalised state in ``state``
// and at the start of ``smem``, after a __syncthreads.
template <int HD, int kWarps>
__device__ __forceinline__ void walk_tiles(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ pages, int b,
    GroupSlice sl, int hq, int hkv, int bs, int n_tok, int t_begin, int t_end,
    float scale, unsigned char* smem, CtaState& state) {
  constexpr int kRow = row_elems<HD>();
  constexpr int kKS = HD / 16;             // k-steps of K Q^T; d tiles of O^T
  constexpr int kCh = HD / 8;              // 16-byte chunks per token row
  __shared__ MergeState<kWarps> st;

  const int h = sl.h, g_size = sl.rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / 4, quad = lane % 4;

  // Q^T as the B operand, in registers for the whole walk: lane holds the
  // slice's q[g = grp][16 s + 2 quad + {0, 1}] and the same 8 columns on;
  // rows g >= sl.rows are zero
  const bf16* qrow = q + ((size_t)b * hq + (size_t)h * (hq / hkv) + sl.g0 + grp) * HD
                     + 2 * quad;
  uint32_t qf[kKS][2];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    qf[s][0] = grp < g_size ? *reinterpret_cast<const uint32_t*>(qrow + 16 * s) : 0u;
    qf[s][1] = grp < g_size ? *reinterpret_cast<const uint32_t*>(qrow + 16 * s + 8) : 0u;
  }

  // this warp's share of the range's tiles
  const int live = (n_tok + bs - 1) / bs;                 // live pages
  const int share = (t_end - t_begin + kWarps - 1) / kWarps;
  const int t_first = min(t_begin + warp * share, t_end);
  const int n = min(t_first + share, t_end) - t_first;
  const int ppt = kTile / bs;                             // pages per tile
  const int p_first = t_first * ppt;
  const int* wpages = pages + p_first;
  const int n_pages = min(live, (t_first + n) * ppt) - p_first;
  int tab_base = 0, tab = table_first(wpages, n_pages, lane);

  bf16* ring = reinterpret_cast<bf16*>(smem) + (size_t)warp * kStages * 2 * kTile * kRow;
  const bf16* kh = k_pages + (size_t)h * HD;
  const bf16* vh = v_pages + (size_t)h * HD;
  const size_t tok_stride = (size_t)hkv * HD;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kKS][4];
#pragma unroll
  for (int i = 0; i < kKS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  // copy tile i of the share into its stage; a tile's pages share one
  // window of the table (ppt divides 32), and rows past the live pages are
  // zero-filled without a load
  auto issue = [&](int i) {
    bf16* kd = ring + (size_t)(i % kStages) * 2 * kTile * kRow;
    bf16* vd = kd + kTile * kRow;
    table_advance(wpages, n_pages, i * ppt, lane, tab_base, tab);
#pragma unroll
    for (int j = 0; j < kTile * kCh / 32; ++j) {
      const int c = lane + 32 * j;
      const int r = c / kCh, d = (c % kCh) * 8;
      const int pi = i * ppt + r / bs;     // the row's page in the share
      const int page = __shfl_sync(0xffffffffu, tab, pi - tab_base);
      const bool ok = pi < n_pages;
      const size_t off = ok ? ((size_t)page * bs + r % bs) * tok_stride + d : 0;
      cp_async16(smem_u32(kd + r * kRow + d), kh + off, ok ? 16 : 0);
      cp_async16(smem_u32(vd + r * kRow + d), vh + off, ok ? 16 : 0);
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_commit();                           // possibly empty: keeps the count
    cp_wait<kStages - 1>();                // tile i has landed
    __syncwarp();
    const bf16* ks = ring + (size_t)(i % kStages) * 2 * kTile * kRow;
    const bf16* vs = ks + kTile * kRow;

    // S^T (16 tokens x 8 query rows) = K Q^T
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int st_ = 0; st_ < kKS; ++st_) {
      uint32_t a[4];
      ldsm_x4(smem_u32(ks + ((lane % 8) + ((lane / 8) % 2) * 8) * kRow + 16 * st_
                       + (lane / 16) * 8), a);
      mma(s, a, qf[st_][0], qf[st_][1]);
    }

    // online softmax over the tile's tokens, per query row (column)
    const int tok = (t_first + i) * kTile + grp;          // tokens tok, tok + 8
    float p[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool v0 = tok < n_tok, v1 = tok + 8 < n_tok;
      const float s0 = v0 ? s[e] * scale : kNegInf;
      const float s1 = v1 ? s[2 + e] * scale : kNegInf;
      const float m_new = fmaxf(m[e], col_max(fmaxf(s0, s1)));
      p[e] = v0 ? expf(s0 - m_new) : 0.f;
      p[2 + e] = v1 ? expf(s1 - m_new) : 0.f;
      alpha[e] = expf(m[e] - m_new);
      l[e] = alpha[e] * l[e] + col_sum(p[e] + p[2 + e]);
      m[e] = m_new;
    }

    // O^T (hd x 8) += V^T P^T; P^T's B fragments are the transposes of
    // the S^T fragments, cast to bf16
    const uint32_t b0 = movmatrix_t(pack(p[0], p[1]));     // tokens 0-7
    const uint32_t b1 = movmatrix_t(pack(p[2], p[3]));     // tokens 8-15
#pragma unroll
    for (int mt = 0; mt < kKS; ++mt) {
      o[mt][0] *= alpha[0]; o[mt][1] *= alpha[1];
      o[mt][2] *= alpha[0]; o[mt][3] *= alpha[1];
      uint32_t a[4];
      ldsm_x4_t(smem_u32(vs + ((lane % 8) + (lane / 16) * 8) * kRow + 16 * mt
                         + ((lane / 8) % 2) * 8), a);
      mma(o[mt], a, b0, b1);
    }
    __syncwarp();                          // the stage is refilled next round
  }

  // the rings are free once every warp is past its walk
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);          // (kWarps, kRows, HD)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = 2 * quad + e;
    if (g < g_size) {
      if (grp == 0) {
        st.m[warp][g] = m[e];
        st.l[warp][g] = l[e];
      }
      float* dst = acc_s + ((size_t)warp * kRows + g) * HD + grp;
#pragma unroll
      for (int mt = 0; mt < kKS; ++mt) {
        dst[16 * mt] = o[mt][e];
        dst[16 * mt + 8] = o[mt][2 + e];
      }
    }
  }
  __syncthreads();
  combine<HD, kWarps>(st, acc_s, state, g_size);
  __syncthreads();
}

}  // namespace warp_walk
