// Mamba-2 SSD chunk scan for Hopper (sm_90a), float32 in and out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (Pallas,
// grid (B, H, chunks) with the chunk axis sequential and the (P, N) state in
// VMEM scratch). It computes what src/repro/models/ssm.py::ssd_chunked
// computes: y, the final state, and optionally the state after every chunk,
// starting from an optional initial state (zeros when it is null). With a
// zero initial state and no per-chunk states it is exactly the Pallas
// kernel's function.
//
//   x    (B, S, H, P)  dt-scaled inputs        dt_a (B, S, H)  A * dt
//   b, c (B, S, N)     shared by all heads     init (B, H, P, N) or null
//   y    (B, S, H, P)  final_state (B, H, P, N)
//   all_states (B, S/L, H, P, N) or null: the state after each chunk
//
// Per chunk of L <= 64 tokens, with a_cum the running sum of dt_a:
//   scores[s][t] = C_s . B_t * exp(a_cum[s] - a_cum[t])   for t <= s
//   y[s]         = sum_t scores[s][t] x_t + exp(a_cum[s]) C_s . state
//   state        = state * exp(a_cum[L-1])
//                  + sum_t exp(a_cum[L-1] - a_cum[t]) x_t B_t^T
//
// What bounds it. At the serve's span shape (B 1, S 128, H 64, P 64, N 128,
// L 64, initial state in, per-chunk states out) the scan needs about 0.37
// GFLOP against about 12.8 MB of traffic. On the float32 FMA units (67
// TFLOP/s) that is 5.5 us of operations against 3.8 us of bytes, so the
// four products run on the tensor cores in 3xTF32: each float32
// operand is split as a = hi + lo (hi = tf32(a), lo = tf32(a - hi)) and
// a.b ~ hi.hi + hi.lo + lo.hi on mma.sync.m16n8k8, the large term summed
// in float32 with rounding to nearest and the small ones apart, which keeps
// float32-level error (plain TF32 keeps 10 mantissa bits, too few for the
// 2e-4 contract, and one truncating tensor-core accumulator for all three
// terms missed it at S 512). Three TF32 products cost
// 3 x 0.37 GFLOP at 495 TFLOP/s = 2.2 us, under the bytes, so with the
// products on the tensor cores the kernel is bound by bytes, and by how
// much of each chunk is in flight while the previous one computes.
//
// Design. Hopper's CTAs run in no order, so the Pallas grid's sequential
// chunk axis is a loop inside one CTA, with the carried state in shared
// memory for the whole sequence. A CTA of 16 warps owns one (batch, head)
// and PS = 32 or 16 rows of its state (a template parameter; the rows
// evolve independently), one CTA an SM with all of a chunk in shared
// memory: B and C (64 x 128 each), x (64 x PS) and dt_a, double-buffered,
// so chunk ci + 1 arrives by 16-byte cp.async while chunk ci computes (its
// copies issued once chunk ci has landed, so they do not delay it). The
// tiles are fixed at L 64, N 128: a smaller chunk, state or head (the
// sweep's P 4-16, N 4-16, L 16-32) runs the same body on zero-padded tiles,
// and its loops stop at the last tile that holds data. The P slices of one
// head form a thread-block cluster: C . B^T and its decay are the same for
// all of them, so each CTA computes some of the chunk's 16-row tiles of the
// scores (Gray-code order balances the triangle between two CTAs) and
// stores each into every CTA of the cluster (remote stores through
// map_shared_rank, which wait on no round trip as pulling the peers' tiles
// did); one cluster.sync() a chunk then makes them
// visible, and double-buffered scores keep a CTA from writing a buffer its
// peers still read. Per chunk:
//   1. warp 0 scans dt_a into a_cum by shuffles;
//   2. the CTA's score tiles: C . B^T on the tensor cores, decayed and
//      masked, the tiles wholly above the diagonal skipped, stored into
//      every CTA of the cluster;
//   3. y = scores . x (depth up to the diagonal) + (exp(a_cum) C) . state^T,
//      one 16 x 8 tile a warp (two half-depth warps when PS = 16), staged
//      in shared memory and stored with 16-byte stores;
//   4. state = state * exp(a_cum[L-1]) + (x * decay)^T . B, written out
//      with 16-byte stores after the chunk when asked, and at the end.
// Shared rows are padded so that every fragment load of the products hits
// 32 distinct banks (the B rows of C . B^T excepted: two-way).
// What bounds this version (PERF.md): at the span shape it is about 9x its
// bytes bound. Most of each chunk goes to the three product stages, each a
// serial chain of up to 16 k-steps a warp with 4 warps a scheduler, issuing
// about 45 instructions per mma triple (half of them operand splits that
// several warps repeat on the same shared operand); then the first chunk's
// exposed copy. Splitting each operand once per chunk, or wgmma, is next.
// Not here: the chunk axis stays sequential (the serve's spans have 1-2
// chunks); splitting it matters only at long S.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kL = 64;                 // chunk rows of the tiles
constexpr int kN = 128;                // state columns of the tiles
// row strides in floats: a fragment load reads rows grp and columns quad
// (stride = 4 mod 32) or rows quad and columns grp (stride = 8 mod 32)
constexpr int kBS = kN + 8;            // B rows: read both ways
constexpr int kCS = kN + 4;            // C rows and state rows
constexpr int kSCS = kL + 4;           // score rows

template <int PS>
struct Layout {
  static constexpr int kXS = PS + 8;   // x rows
  static constexpr int kYS = PS + 4;   // y staging rows
  static constexpr int b_off = 0;                              // [2][kL][kBS]
  static constexpr int c_off = b_off + 2 * kL * kBS;           // [2][kL][kCS]
  static constexpr int x_off = c_off + 2 * kL * kCS;           // [2][kL][kXS]
  static constexpr int dt_off = x_off + 2 * kL * kXS;          // [2][kL]
  static constexpr int st_off = dt_off + 2 * kL;               // [PS][kCS]
  static constexpr int sc_off = st_off + PS * kCS;             // [2][kL][kSCS]
  static constexpr int y_off = sc_off + 2 * kL * kSCS;         // [kL][kYS]
  static constexpr int acum_off = y_off + kL * kYS;            // [kL]
  static constexpr int dec_off = acum_off + kL;                // [kL]
  static constexpr int es_off = dec_off + kL;                  // [kL]
  static constexpr int floats = es_off + kL;
  static constexpr size_t bytes = sizeof(float) * (size_t)floats;
  static_assert(floats % 4 == 0 && x_off % 4 == 0 && st_off % 4 == 0 &&
                sc_off % 4 == 0 && y_off % 4 == 0, "16-byte aligned regions");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a = hi + lo as TF32 operands. hi is a rounded to TF32 (half a TF32 ulp
// added to the bits, the 13 low bits cleared), lo = a - hi exactly, with
// half an ulp added so that the tensor core, which ignores an operand's 13
// low bits, rounds it too. Integer and float adds at full rate: a
// cvt.rna.tf32.f32 is a quarter-rate conversion, and twelve of them a
// product of fragments cost more issue slots than its three mma.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc + cor += a (16x8, row) * b (8x8, col) in 3xTF32. The tensor core
// truncates as it accumulates, so a long float32 sum kept in its
// accumulator drifts toward zero: hi.hi is summed from zero (8 products)
// and added to acc in float32 with rounding to nearest; the two small
// terms hi.lo + lo.hi, about 2^-11 of it, accumulate in cor on the tensor
// core, and the caller adds cor at the end.
// Fragments (lane = 4 grp + quad): a = rows grp, grp + 8 at columns quad,
// quad + 4 as {a[0]: (grp, quad), a[1]: (grp+8, quad), a[2]: (grp, quad+4),
// a[3]: (grp+8, quad+4)}; b = {(k quad, n grp), (k quad+4, n grp)}; c =
// {(grp, 2quad), (grp, 2quad+1), (grp+8, 2quad), (grp+8, 2quad+1)}.
__device__ __forceinline__ void mma3(float (&acc)[4], float (&cor)[4],
                                     const float (&a)[4], float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(cor, al, bh0, bh1);
  mma_tf32(cor, ah, bl0, bl1);
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(m, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += m[i];
}

// the CTA of a cluster that computes the scores' 16-row tile i: Gray-code
// order gives two CTAs tiles {0, 3} and {1, 2} of a 64-row chunk, equal
// shares of the triangle
__device__ __forceinline__ int tile_owner(int i, int nps) { return (i ^ (i >> 1)) % nps; }

template <int PS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_tc_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                   const float* __restrict__ b_g, const float* __restrict__ c_g,
                   const float* __restrict__ init, float* __restrict__ y,
                   float* __restrict__ final_state, float* __restrict__ all_states,
                   int S, int H, int P, int N, int L) {
  using Lay = Layout<PS>;
  constexpr int kXS = Lay::kXS, kYS = Lay::kYS;
  constexpr int kNT = PS / 8;                 // n8 tiles of a y row tile
  constexpr int kTilesY = (kL / 16) * kNT;    // 16 x 8 tiles of y
  constexpr int kParts = kWarps / kTilesY;    // warps a y tile (depth halves)
  static_assert(kParts == 1 || kParts == 2, "PS is 16 or 32");
  extern __shared__ __align__(16) float smem[];
  float* const st = smem + Lay::st_off;
  float* const ys = smem + Lay::y_off;
  float* const acum = smem + Lay::acum_off;
  float* const dec = smem + Lay::dec_off;
  float* const es = smem + Lay::es_off;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nps = (int)gridDim.x;  // grid x = cluster x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(PS, P - p0);             // live state rows (P < PS pads)
  const int nc = S / L;
  const int R = (L + 15) / 16;                // 16-row tiles holding data
  const int KN = (N + 7) / 8;                 // k-steps over the state
  const int KL = (L + 7) / 8;                 // k-steps over the chunk
  const bool vec_n = N % 4 == 0;
  const size_t bh = (size_t)b * H + h;

  // zero everything once: rows past L, columns past N and state rows past
  // P are never copied into and stay zero for the whole scan
  for (int i = tid * 4; i < Lay::floats; i += kThreads * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  auto load_chunk = [&](int ci, int buf) {
    const size_t t0 = (size_t)b * S + (size_t)ci * L;
    float* bd = smem + Lay::b_off + buf * kL * kBS;
    float* cd = smem + Lay::c_off + buf * kL * kCS;
    float* xd = smem + Lay::x_off + buf * kL * kXS;
    float* dd = smem + Lay::dt_off + buf * kL;
    const float* bsrc = b_g + t0 * N;        // the chunk's B and C rows are contiguous
    const float* csrc = c_g + t0 * N;
    if (vec_n) {
      const int n4 = N / 4;
      for (int i = tid; i < L * n4; i += kThreads) {
        const int l = i / n4, c = (i % n4) * 4;
        cp_async16(bd + l * kBS + c, bsrc + (size_t)l * N + c);
        cp_async16(cd + l * kCS + c, csrc + (size_t)l * N + c);
      }
    } else {
      for (int i = tid; i < L * N; i += kThreads) {
        const int l = i / N, n = i % N;
        cp_async4(bd + l * kBS + n, bsrc + i);
        cp_async4(cd + l * kCS + n, csrc + i);
      }
    }
    const int x4 = pw / 4;
    for (int i = tid; i < L * x4; i += kThreads) {
      const int l = i / x4, c = (i % x4) * 4;
      cp_async16(xd + l * kXS + c, x + ((t0 + l) * H + h) * P + p0 + c);
    }
    for (int l = tid; l < L; l += kThreads) cp_async4(dd + l, dt_a + (t0 + l) * H + h);
  };

  if (init) {
    const float* src = init + (bh * P + p0) * N;
    if (vec_n) {
      const int n4 = N / 4;
      for (int i = tid; i < pw * n4; i += kThreads) {
        const int j = i / n4, c = (i % n4) * 4;
        cp_async16(st + j * kCS + c, src + (size_t)j * N + c);
      }
    } else {
      for (int i = tid; i < pw * N; i += kThreads)
        cp_async4(st + (i / N) * kCS + i % N, src + i);
    }
  }
  load_chunk(0, 0);
  cp_commit();

  for (int ci = 0; ci < nc; ++ci) {
    const int buf = ci & 1;
    const size_t t0 = (size_t)b * S + (size_t)ci * L;
    const float* bs = smem + Lay::b_off + buf * kL * kBS;
    const float* cs = smem + Lay::c_off + buf * kL * kCS;
    const float* xs = smem + Lay::x_off + buf * kL * kXS;
    float* sc = smem + Lay::sc_off + buf * kL * kSCS;
    cp_wait0();                               // this chunk (and the state) landed
    __syncthreads();
    // the other buffer was last read before the previous chunk's final
    // __syncthreads: the next chunk goes into it while this one computes
    // (issued only now, so that it does not delay this chunk's copies)
    if (ci + 1 < nc) {
      load_chunk(ci + 1, buf ^ 1);
      cp_commit();
    }

    // ---- 1. a_cum by shuffles; padded rows add 0 and carry a_cum[L-1]
    if (warp == 0) {
      const float* dd = smem + Lay::dt_off + buf * kL;
      float v0 = dd[lane], v1 = dd[lane + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float total = __shfl_sync(0xffffffffu, v1, 31);
      acum[lane] = v0;
      acum[lane + 32] = v1;
      dec[lane] = expf(total - v0);
      dec[lane + 32] = expf(total - v1);
      es[lane] = expf(v0);
      es[lane + 32] = expf(v1);
    }
    __syncthreads();

    // ---- 2. this CTA's 16-row tiles of the scores, one 16 x 8 tile a warp
    {
      int u = 0;
      for (int i = 0; i < R; ++i) {
        if (tile_owner(i, nps) != rank) continue;
        for (int c = 0; c < 2 * (i + 1); ++c, ++u) {
          if (u % kWarps != warp) continue;
          float acc[4] = {0.f, 0.f, 0.f, 0.f}, cor[4] = {0.f, 0.f, 0.f, 0.f};
          const float* ca = cs + (16 * i + grp) * kCS + quad;
          const float* bb = bs + (8 * c + grp) * kBS + quad;
#pragma unroll 4
          for (int k = 0; k < KN; ++k) {
            const float a[4] = {ca[8 * k], ca[8 * kCS + 8 * k], ca[8 * k + 4],
                                ca[8 * kCS + 8 * k + 4]};
            mma3(acc, cor, a, bb[8 * k], bb[8 * k + 4]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += cor[j];
          // into this CTA's scores and, by remote stores, its peers'
          float v[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int s = 16 * i + grp + 8 * r;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = 8 * c + 2 * quad + e;
              v[2 * r + e] = t <= s ? acc[2 * r + e] * expf(acum[s] - acum[t]) : 0.f;
            }
          }
          const int off = (16 * i + grp) * kSCS + 8 * c + 2 * quad;
          for (int r = 0; r < nps; ++r) {
            float* dst = r == rank ? sc : cluster.map_shared_rank(sc, r);
            *reinterpret_cast<float2*>(dst + off) = make_float2(v[0], v[1]);
            *reinterpret_cast<float2*>(dst + off + 8 * kSCS) = make_float2(v[2], v[3]);
          }
        }
      }
    }
    cluster.sync();                           // every CTA's tiles are in place

    // ---- 3. y tile (ry, ny): scores . x + (exp(a_cum) C) . state^T
    {
      const int tile = warp % kTilesY, part = warp / kTilesY;
      const int ry = tile / kNT, ny = tile % kNT;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, cor[4] = {0.f, 0.f, 0.f, 0.f};
      if (ry < R) {
        if (kParts == 1 || part == 1) {
          const float e0 = es[16 * ry + grp], e1 = es[16 * ry + grp + 8];
          const float* ca = cs + (16 * ry + grp) * kCS + quad;
          const float* sb = st + (8 * ny + grp) * kCS + quad;
#pragma unroll 4
          for (int k = 0; k < KN; ++k) {
            const float a[4] = {ca[8 * k] * e0, ca[8 * kCS + 8 * k] * e1,
                                ca[8 * k + 4] * e0, ca[8 * kCS + 8 * k + 4] * e1};
            mma3(acc, cor, a, sb[8 * k], sb[8 * k + 4]);
          }
        }
        if (kParts == 1 || part == 0) {
          const float* sa = sc + (16 * ry + grp) * kSCS + quad;
          const float* xb = xs + quad * kXS + 8 * ny + grp;
          for (int k = 0; k < 2 * (ry + 1); ++k) {
            const float a[4] = {sa[8 * k], sa[8 * kSCS + 8 * k], sa[8 * k + 4],
                                sa[8 * kSCS + 8 * k + 4]};
            mma3(acc, cor, a, xb[8 * k * kXS], xb[(8 * k + 4) * kXS]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += cor[j];
      }
      float* yd = ys + (16 * ry + grp) * kYS + 8 * ny + 2 * quad;
      if (kParts == 2) {
        if (part == 1 && ry < R) {
          *reinterpret_cast<float2*>(yd) = make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(yd + 8 * kYS) = make_float2(acc[2], acc[3]);
        }
        __syncthreads();
      }
      if (part == 0 && ry < R) {
        if (kParts == 2) {
          const float2 u0 = *reinterpret_cast<const float2*>(yd);
          const float2 u1 = *reinterpret_cast<const float2*>(yd + 8 * kYS);
          acc[0] += u0.x; acc[1] += u0.y; acc[2] += u1.x; acc[3] += u1.y;
        }
        *reinterpret_cast<float2*>(yd) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(yd + 8 * kYS) = make_float2(acc[2], acc[3]);
      }
    }
    __syncthreads();                          // y staged; the state is read
    {
      const int x4 = pw / 4;
      for (int i = tid; i < L * x4; i += kThreads) {
        const int s = i / x4, c = (i % x4) * 4;
        *reinterpret_cast<float4*>(y + ((t0 + s) * H + h) * P + p0 + c) =
            *reinterpret_cast<const float4*>(ys + s * kYS + c);
      }
    }

    // ---- 4. state rows 16 rt.., columns 8 warp..: (x * decay)^T . B
    if (warp < KN) {
      constexpr int kRT = PS / 16;
      float acc[kRT][4] = {}, cor[kRT][4] = {};
      const float* bb = bs + quad * kBS + 8 * warp + grp;
      for (int k = 0; k < KL; ++k) {
        const float b0 = bb[8 * k * kBS], b1 = bb[(8 * k + 4) * kBS];
        const float d0 = dec[8 * k + quad], d1 = dec[8 * k + quad + 4];
#pragma unroll
        for (int rt = 0; rt < kRT; ++rt) {
          const float* xa = xs + (8 * k + quad) * kXS + 16 * rt + grp;
          const float a[4] = {xa[0] * d0, xa[8] * d0, xa[4 * kXS] * d1,
                              xa[4 * kXS + 8] * d1};
          mma3(acc[rt], cor[rt], a, b0, b1);
        }
      }
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[rt][j] += cor[rt][j];
      const float chunk_decay = es[kL - 1];   // exp(a_cum[L-1])
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* sp = reinterpret_cast<float2*>(
              st + (16 * rt + grp + 8 * r) * kCS + 8 * warp + 2 * quad);
          const float2 v = *sp;
          *sp = make_float2(v.x * chunk_decay + acc[rt][2 * r],
                            v.y * chunk_decay + acc[rt][2 * r + 1]);
        }
      }
    }
    __syncthreads();
    const bool last = ci == nc - 1;
    if (all_states || last) {
      float* as = all_states ? all_states + ((((size_t)b * nc + ci) * H + h) * P + p0) * N
                             : nullptr;
      float* fs = final_state + (bh * P + p0) * N;
      if (vec_n) {
        const int n4 = N / 4;
        for (int i = tid; i < pw * n4; i += kThreads) {
          const int j = i / n4, c = (i % n4) * 4;
          const float4 v = *reinterpret_cast<const float4*>(st + j * kCS + c);
          if (as) *reinterpret_cast<float4*>(as + (size_t)j * N + c) = v;
          if (last) *reinterpret_cast<float4*>(fs + (size_t)j * N + c) = v;
        }
      } else {
        for (int i = tid; i < pw * N; i += kThreads) {
          const float v = st[(i / N) * kCS + i % N];
          if (as) as[i] = v;
          if (last) fs[i] = v;
        }
      }
    }
  }
}

template <int PS>
int launch(const float* x, const float* dt_a, const float* b, const float* c,
           const float* init, float* y, float* final_state, float* all_states, int B,
           int S, int H, int P, int N, int L, cudaStream_t st) {
  constexpr size_t smem = Layout<PS>::bytes;
  static bool attr_set = false;               // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nps = P >= PS ? P / PS : 1;       // the P slices of a head: one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nps, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nps;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_scan_tc_kernel<PS>, x, dt_a, b, c,
                                           init, y, final_state, all_states, S, H, P, N,
                                           L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/ssd_scan.py) has checked the
// shapes, made every operand contiguous float32 and 16-byte aligned, and
// picked PS (16 or 32). Returns the cudaError_t of the launch.
extern "C" int ssd_scan(const float* x, const float* dt_a, const float* b,
                        const float* c, const float* init, float* y,
                        float* final_state, float* all_states, int B, int S,
                        int H, int P, int N, int L, int PS, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kL || N < 1 || N > kN || P < 4 || P % 4 ||
      (PS != 16 && PS != 32) || (P > PS && P % PS) || S < L || S % L)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (PS == 32)
    return launch<32>(x, dt_a, b, c, init, y, final_state, all_states, B, S, H, P, N, L, st);
  return launch<16>(x, dt_a, b, c, init, y, final_state, all_states, B, S, H, P, N, L, st);
}
