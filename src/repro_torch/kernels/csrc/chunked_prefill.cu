// Chunked-prefill causal attention with a fused epilogue, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill.py:
// chunked_prefill_attention (body _kernel). Same contract: q (Sc,Hq,hd) at
// absolute positions ctx+i; k/v (T,Hkv,hd), float32 or bfloat16; scalar ctx
// -> (Sc,Hq,hd) in q's dtype. Query row i sees key j iff j <= ctx+i (and
// j < T); query head h reads kv head h / G, G = Hq/Hkv; scale 1/sqrt(hd).
//
// What bounds it on the card: a chunk does 4*hd flops per visible (query
// head, key) pair and reads (ctx+Sc)*Hkv*hd*2*itemsize of K/V once, about
// G*Sc flops per byte once the prefix is long: 256 at qwen3-4b's G = 4 and
// the engine's Sc = 64, near the ~295 at which the H100's bf16 tensor cores
// stop waiting for memory. At that shape the whole chunk is 0.5 GFLOP and
// 3.1 MB, so what the card can do in the time is set by how well the few
// CTAs keep the tensor cores fed, not by either roof.
//
// bfloat16 (chunked_prefill_tc_kernel), the serving path:
//   * GQA packed into the rows: one CTA per (kv head, tile of kBM packed
//     rows), packed row r = query position r / G, group member r % G, so a
//     K/V tile is read once per kv head instead of once per query head, and
//     a query position's G rows are contiguous in q and out;
//   * both products on the tensor cores: mma.sync.m16n8k16 bf16 with
//     float32 accumulators, one warp per 16 packed rows; Q is loaded once
//     (ldmatrix) and stays in registers for the whole walk; K fragments by
//     ldmatrix, V by ldmatrix.trans; the online softmax stays in float32 on
//     the score fragments (exp2 with the scale folded in), and P is cast to
//     bf16 in registers before P.V, as the plain version casts the
//     probabilities to q.dtype;
//   * kStages K/V tiles of kBN keys in a ring in shared memory, loaded with
//     16-byte cp.async.cg, so the next kStages - 1 tiles are in flight while
//     the current one is multiplied; rows padded by 16 bytes keep ldmatrix free of bank
//     conflicts; dynamic shared memory (above 48 KB);
//   * causal and ragged edges: keys are walked only up to the tile's
//     frontier, ctx + its last query position + 1, clipped to T; keys at or
//     past the frontier are zero-filled by cp.async's source-size operand
//     (no load is issued for them); tiles wholly below the diagonal skip the
//     mask; padded rows past Sc*G are zero-filled and never stored; mask
//     -1e30, normalise by max(l, 1e-20), cast, store.
// The tile height kBM (64 or 32 packed rows) is a launch choice: 64 halves
// the number of CTAs, 32 doubles them (the wrapper picks; chip_smoke.py
// times both).
//
// float32 (chunked_prefill_simt_kernel) keeps the first version's body, on
// the float32 FMA units: the float32 parity tests hold the port to 2e-4 and
// compare greedy tokens of tiny float32 models, which TF32 tensor cores
// (about three decimal digits) would not meet. One CTA per (query head,
// tile of 16 query rows), key tiles of 32 up to the causal frontier, a
// mask-free path below the diagonal, float32 online softmax with the
// accumulator in registers.
//
// wgmma, TMA, splitting the keys across CTAs and reading the pages through
// the block table in the kernel are later work.

#include "mma_ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------ bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace ptx;
constexpr int kBN = 64;        // keys per tile
constexpr int kStages = 4;     // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
__host__ __device__ constexpr int row_elems() { return HD + 8; }   // 16-byte pad per row

template <int HD, int kWarps>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(16 * kWarps + 2 * kStages * kBN) * row_elems<HD>() * sizeof(bf16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * group + quad): an
// accumulator c[0..1] is row group, columns 2*quad + {0, 1}; c[2..3] the
// same columns of row group + 8. A thread therefore owns two packed rows,
// and a row's values are spread over the 4 lanes of a quad.
template <int HD, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 1)
chunked_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int sc, int t_len, int hq, int hkv, int ctx,
                          float scale_log2) {
  constexpr int kBM = 16 * kWarps;         // packed rows per CTA
  constexpr int kThr = kWarps * 32;
  constexpr int kRow = row_elems<HD>();
  constexpr int kCh = HD / 8;              // 16-byte chunks per row
  constexpr int kKS = HD / 16;             // k-steps of Q.K^T
  constexpr int kNT = kBN / 8;             // key columns of S, in 8s
  constexpr int kDT = HD / 8;              // output columns, in 8s
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // kBM x kRow
  bf16* ks = qs + kBM * kRow;                      // kStages x kBN x kRow
  bf16* vs = ks + kStages * kBN * kRow;

  const int kvh = blockIdx.x;
  const int g_size = hq / hkv;
  const int rows = sc * g_size;            // packed rows of this kv head
  const int r0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Q tile; packed row r is query r / G, head kvh * G + r % G
  for (int c = tid; c < kBM * kCh; c += kThr) {
    const int r = c / kCh, d = (c % kCh) * 8;
    const int row = r0 + r;
    const bool ok = row < rows;
    const size_t off = ok ? ((size_t)(row / g_size) * hq + (size_t)kvh * g_size
                             + row % g_size) * HD + d : 0;
    cp_async16(smem_u32(qs + r * kRow + d), q + off, ok ? 16 : 0);
  }
  cp_commit();

  const int last = min(r0 + kBM, rows) - 1;
  const int k_end = min(t_len, ctx + last / g_size + 1);   // causal frontier
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int first_q = r0 / g_size;         // the tile's first query position

  auto load_kv = [&](int kt) {
    const int k0 = kt * kBN, stage = kt % kStages;
    bf16* kd = ks + stage * kBN * kRow;
    bf16* vd = vs + stage * kBN * kRow;
    for (int c = tid; c < kBN * kCh; c += kThr) {
      const int j = c / kCh, d = (c % kCh) * 8;
      const bool ok = k0 + j < k_end;
      const size_t off = ok ? ((size_t)(k0 + j) * hkv + kvh) * HD + d : 0;
      cp_async16(smem_u32(kd + j * kRow + d), k + off, ok ? 16 : 0);
      cp_async16(smem_u32(vd + j * kRow + d), v + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_commit();                           // possibly empty: keeps the count
  }

  const int grp = lane / 4, quad = lane % 4;
  const int row_a = r0 + warp * 16 + grp;            // rows row_a, row_a + 8
  const int qpos[2] = {row_a / g_size, (row_a + 8) / g_size};
  uint32_t qf[kKS][4];
  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + kStages - 1 < n_tiles) load_kv(kt + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();                // Q and tile kt have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        const int r = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldsm_x4(smem_u32(qs + r * kRow + s * 16 + (lane / 16) * 8), qf[s]);
      }
    }
    const bf16* kt_s = ks + (kt % kStages) * kBN * kRow;
    const bf16* vt_s = vs + (kt % kStages) * kBN * kRow;

    // S = Q K^T for this warp's 16 rows and the tile's kBN keys
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kKS; ++st) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t b[4];
        const int key = nt * 8 + (lane % 8) + (lane / 16) * 8;
        ldsm_x4(smem_u32(kt_s + key * kRow + st * 16 + ((lane / 8) % 2) * 8), b);
        mma(s[nt], qf[st], b[0], b[1]);
        mma(s[nt + 1], qf[st], b[2], b[3]);
      }
    }

    // online softmax in the log2 domain; mask-free iff every key of the
    // tile exists and is visible to the tile's first query position
    const int k0 = kt * kBN;
    const bool full = (k0 + kBN - 1 <= ctx + first_q) && (k0 + kBN <= t_len);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * quad + (e & 1);
        const bool ok = full || (key < t_len && key <= ctx + qpos[e / 2]);
        s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          // a masked score gives exactly 0: key 0 is visible to every row,
          // so m_new is finite from the first tile on
          s[nt][e] = exp2f(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      }
      l[h] = alpha * l[h] + sum;           // per-thread share; quad-summed at the end
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }

    // O += P V, P cast to bf16 in registers (its C fragments are A's)
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t b[4];
        ldsm_x4_t(smem_u32(vt_s + key * kRow + dt * 8 + (lane / 16) * 8), b);
        mma(o[dt], a, b[0], b[1]);
        mma(o[dt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                       // the stage is refilled next round
  }

  // epilogue: normalise once, cast, store rows < Sc * G
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = __fdividef(1.f, fmaxf(quad_sum(l[h]), 1e-20f));
    const int row = row_a + 8 * h;
    if (row < rows) {
      bf16* dst = out + ((size_t)(row / g_size) * hq + (size_t)kvh * g_size
                         + row % g_size) * HD + 2 * quad;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
    }
  }
}

template <int HD, int kWarps>
int launch(const void* q, const void* k, const void* v, void* out, int sc,
           int t_len, int hq, int hkv, int ctx, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD, kWarps>();
  static bool attr_set = false;            // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_prefill_tc_kernel<HD, kWarps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int rows = sc * (hq / hkv);
  const dim3 grid(hkv, (rows + 16 * kWarps - 1) / (16 * kWarps));
  chunked_prefill_tc_kernel<HD, kWarps><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sc, t_len, hq, hkv,
      ctx, kLog2e / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_rows(const void* q, const void* k, const void* v, void* out, int sc,
                int t_len, int hq, int hkv, int ctx, int tile_rows, cudaStream_t st) {
  if (tile_rows == 32) return launch<HD, 2>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
  if (tile_rows == 64) return launch<HD, 4>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// ------------------------------------------------ float32: FMA units
namespace simt {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBQ = 16;         // query rows per CTA
constexpr int kBK = 32;         // keys per tile: one per lane
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
chunked_prefill_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            int sc, int t_len, int hq, int hkv, int ctx, float scale) {
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
        row < sc ? *reinterpret_cast<const float4*>(q + ((size_t)row * hq + h) * HD + d)
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
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
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
    if (row < sc) out[((size_t)row * hq + h) * HD + d] = acc[a] / fmaxf(l_s[r], 1e-20f);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int sc,
           int t_len, int hq, int hkv, int ctx, cudaStream_t st) {
  const dim3 grid(hq, (sc + kBQ - 1) / kBQ);
  chunked_prefill_simt_kernel<HD><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sc, t_len, hq, hkv,
      ctx, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

int dispatch(const void* q, const void* k, const void* v, void* out, int sc,
             int t_len, int hq, int hkv, int hd, int ctx, int is_bf16,
             int tile_rows, cudaStream_t st) {
  if (is_bf16) {
    switch (hd) {
      case 16: return tc::launch_rows<16>(q, k, v, out, sc, t_len, hq, hkv, ctx, tile_rows, st);
      case 32: return tc::launch_rows<32>(q, k, v, out, sc, t_len, hq, hkv, ctx, tile_rows, st);
      case 64: return tc::launch_rows<64>(q, k, v, out, sc, t_len, hq, hkv, ctx, tile_rows, st);
      case 128: return tc::launch_rows<128>(q, k, v, out, sc, t_len, hq, hkv, ctx, tile_rows, st);
    }
  } else {
    switch (hd) {
      case 16: return simt::launch<16>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
      case 32: return simt::launch<32>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
      case 64: return simt::launch<64>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
      case 128: return simt::launch<128>(q, k, v, out, sc, t_len, hq, hkv, ctx, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/chunked_prefill.py) has checked
// shapes, dtypes, contiguity, alignment and hd in {16, 32, 64, 128}, and
// picked tile_rows (32 or 64 packed rows a CTA; read for bf16 only).
// Returns the cudaError_t of the launch.
extern "C" int chunked_prefill_attention(const void* q, const void* k,
                                         const void* v, void* out, int sc,
                                         int t_len, int hq, int hkv, int hd,
                                         int ctx, int is_bf16, int tile_rows,
                                         void* stream) {
  return dispatch(q, k, v, out, sc, t_len, hq, hkv, hd, ctx, is_bf16, tile_rows,
                  static_cast<cudaStream_t>(stream));
}
