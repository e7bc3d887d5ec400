// Backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), float32.
//
// Port-only: the JAX package differentiates its XLA ssd_chunked
// (src/repro/models/ssm.py:61) and has no Pallas backward; the port's forward is
// a kernel (ssd_scan.cu), whose outputs carry no autograd graph, so its
// gradient is a kernel too. It computes what the plain backward
// repro_torch/kernels/ssd_scan.py::ssd_chunked_bwd computes:
//
//   in:  x (B,S,H,P), dt_a (B,S,H), b, c (B,S,N), states (B,S/L,H,P,N):
//        the state after each chunk (the forward's), dy (B,S,H,P), dfinal
//        (B,H,P,N); the scan starts from a zero state (the training path
//        passes no initial state, and the wrapper raises for one)
//   out: dx (B,S,H,P), d dt_a (B,S,H), dB, dC (B,S,N)
//   scratch: dh_end (B,S/L,H,P,N), and the dB, dC partials of each group of
//        heads (B*S*N floats a group each)
//
// Per chunk of L <= 64 tokens, A the running sum of dt_a, W[l][s] =
// exp(A_l - A_s) for s <= l, G = C B^T, D = dy x^T, H0 the state entering
// the chunk (zero or the previous chunk's saved state) and dH the adjoint of
// the state leaving it:
//   dx_s  = sum_l W G dy_l + exp(A_L - A_s) dH B_s
//   dB_s  = sum_l W D C_l + exp(A_L - A_s) dH^T x_s
//   dC_l  = sum_s W D B_s + exp(A_l) H0^T dy_l
//   dA_l  = rowsum_l(M) - colsum_l(M) + exp(A_l) dy_l.(H0 C_l)
//           - exp(A_L - A_l) x_l.(dH B_l), M = W G D; the last position also
//           takes exp(A_L) <dH, H0> + sum_s exp(A_L - A_s) x_s.(dH B_s)
//   dH of the chunk before = exp(A_L) dH + sum_l exp(A_l) dy_l C_l^T
// and d dt_a is the reverse running sum of dA within the chunk. Every
// exponent is of a segment sum that ends after it starts (at most 0):
// nothing is rebuilt backwards through exp(-A).
//
// What bounds it. At mamba2-1.3b's training shape (B 1, S 4096, H 64, P 64,
// N 128, L 64) the formulas need 19.46 GFLOP on the causal half of each
// chunk (C B^T and the two products with the heads' sum of W D once a
// chunk: B and C are shared by the heads; per head D, (W G)^T dy and four
// state-sized products) against 0.35 GB of inputs and outputs: 0.29 ms on
// the float32 FMA units, 0.12 ms as three TF32 products on the tensor
// cores, 0.10 ms of bytes. So every
// product runs on the tensor cores in 3xTF32 (mma.sync.m16n8k8, the
// forward's operand split, ptx::split_tf32): hi.hi summed from zero and the
// two small terms from zero apart, each added to a float32 sum with
// rounding to nearest, since the tensor core truncates as it accumulates
// (plain TF32 keeps too few bits for the 1e-5 contract). Only the adjoint
// dH carries from chunk to chunk; everything else is chunk-local.
//
// Design: three launches.
//  1. ssd_bwd_dh_kernel: one CTA of 8 warps per (batch, head, 32 state
//     rows) walks the chunks last first and carries only dH, in registers
//     (warp w owns columns 16w..16w+15), writing it for every chunk into
//     dh_end (chunk S/L - 1 gets dfinal). A chunk's product (exp(A) dy)^T C
//     is 32 x L x N; a ring of four chunks of C, dy and dt_a keeps three in
//     flight by cp.async while one computes, and each warp scans dt_a
//     itself, so a chunk costs one __syncthreads.
//  2. ssd_bwd_chunk_kernel: one CTA of 16 warps per (batch, chunk, group of
//     up to 8 heads): 512 CTAs at mamba2's shape. It stages the chunk's B,
//     C and dt_a once, computes G = C B^T once for the group (the 16 x 8
//     tiles on or below the diagonal only), then walks the group's heads a
//     slice of 16 state rows at a time through a two-stage cp.async ring
//     of (x, dy, H0, dH) slices. Warps w and w + 8 are a pair that shares
//     one 16 x 8 tile of U = dH B, half of its depth N each, handed over
//     through shared memory at a named barrier of the two. Warps 0-7 then
//     own dx = (W G)^T dy + exp(A_L - A) U on that tile, the x.U term of
//     dA and 16 columns of dB; warps 8-15 own 16 columns of dC, whose
//     per-head products dotted with C give the dy.(H0 C) term of dA (so
//     H0 C is never formed), and D = dy x^T (kept in shared memory). dB
//     and dC are summed over the group's heads in registers: the per-head
//     terms dH^T x and H0^T dy as products scaled row by row, and the
//     intra-chunk terms as one product with the group's sum of W D (B and
//     C are the same for every head). One CTA owns a (chunk, head), so it
//     writes dx and d dt_a (a warp-shuffle reverse scan) directly.
//  3. ssd_bwd_sum_kernel: dB and dC = the groups' partials summed in group
//     order.
// Every sum runs in a fixed order (no atomics): two runs on the same
// inputs give bitwise-equal gradients. Tiles are held at L 64, N 128 and
// 16 or 32 state rows, zero past the chunk, the state and the head, so a
// smaller shape (the sweep's P 4-16, N 4-16, L 16-32) runs the same body
// on zero-padded tiles. Shared rows are padded so that the hot fragment
// loads hit distinct banks.
// What bounds this version (PERF.md): at mamba2's shape the chunk launch
// takes about three quarters of the time and is latency-bound. Its
// products are a serial chain a warp at 4 warps a scheduler, about 40
// instructions a 3xTF32 fragment product (half of them operand splits,
// repeated where several warps read one operand), and two ring stages
// (210 KB of shared memory) overlap the copies with them only in part;
// the walk is a chain of one step a chunk. Operands are split in
// registers, each time a warp loads them: splitting x and dy once where
// they are staged (tools/ssd_bwd_split_once.patch) doubles their
// fragment loads, needs 20 KB more shared memory, spills, and was slower;
// B and C split once would not fit beside the ring. wgmma, whose
// operands come from shared memory, or deeper rings, are next.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

using ptx::cp_async16;
using ptx::cp_async4;
using ptx::cp_commit;
using ptx::cp_wait;
using ptx::mma_tf32;
using ptx::smem_u32;
using ptx::split_tf32;

constexpr int kL = 64;                  // chunk rows of the tiles
constexpr int kN = 128;                 // state columns of the tiles
constexpr int kRows = 16;               // state rows of a chunk-kernel slice
constexpr int kLower = 20;              // 16 x 8 tiles of an L x L product on or below the diagonal
constexpr int kSmemLimit = 232448;

// ------------------------------------------------------------ helpers
// Fragments of mma.sync.m16n8k8 (lane = 4 grp + quad): A (16 x 8, row) =
// {(grp, quad), (grp+8, quad), (grp, quad+4), (grp+8, quad+4)}; B (8 x 8,
// col) = {(k quad, n grp), (k quad+4, n grp)}; C = {(grp, 2quad), (grp,
// 2quad+1), (grp+8, 2quad), (grp+8, 2quad+1)}. Each operand is split into
// TF32 hi and lo once, as it is loaded, and feeds every product of the
// warp's register tile.
struct SplitA {
  uint32_t h[4], l[4];
};
struct SplitB {
  uint32_t h0, h1, l0, l1;
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA f;
  split_tf32(a0, f.h[0], f.l[0]);
  split_tf32(a1, f.h[1], f.l[1]);
  split_tf32(a2, f.h[2], f.l[2]);
  split_tf32(a3, f.h[3], f.l[3]);
  return f;
}
__device__ __forceinline__ SplitB split_b(float b0, float b1) {
  SplitB f;
  split_tf32(b0, f.h0, f.l0);
  split_tf32(b1, f.h1, f.l1);
  return f;
}
// big = hi.hi and small = lo.hi + hi.lo, each summed from zero over the 8
// products of the k-step
__device__ __forceinline__ void mma3_terms(float (&big)[4], float (&small)[4],
                                           const SplitA& a, const SplitB& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) big[i] = small[i] = 0.f;
  mma_tf32(small, a.l, b.h0, b.h1);
  mma_tf32(small, a.h, b.l0, b.l1);
  mma_tf32(big, a.h, b.h0, b.h1);
}
// acc += a b in 3xTF32
__device__ __forceinline__ void mma3(float (&acc)[4], const SplitA& a, const SplitB& b) {
  float big[4], small[4];
  mma3_terms(big, small, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += big[i] + small[i];
}
// acc += diag(r) a b: the product's rows grp and grp + 8 scaled by r0, r1
__device__ __forceinline__ void mma3_rows(float (&acc)[4], const SplitA& a,
                                          const SplitB& b, float r0, float r1) {
  float big[4], small[4];
  mma3_terms(big, small, a, b);
  acc[0] = fmaf(r0, big[0] + small[0], acc[0]);
  acc[1] = fmaf(r0, big[1] + small[1], acc[1]);
  acc[2] = fmaf(r1, big[2] + small[2], acc[2]);
  acc[3] = fmaf(r1, big[3] + small[3], acc[3]);
}

// the 16 x 8 tile u (0..19) of an L x L product on or below the diagonal:
// row tile ti (16 rows) and column tile tj (8 columns), tj <= 2 ti + 1
__device__ __forceinline__ void lower_tile(int u, int& ti, int& tj) {
  ti = u < 2 ? 0 : u < 6 ? 1 : u < 12 ? 2 : 3;
  tj = u - ti * (ti + 1);
}

// rows x cols floats from src (row stride lds) into shared dst (row stride
// ldd) by cp.async, NT threads: 16-byte copies where rows are whole ones,
// else 4-byte
template <int NT>
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src,
                                          size_t lds, int rows, int cols, int tid) {
  if (cols % 4 == 0 && lds % 4 == 0) {
    const int c4 = cols / 4;
    for (int i = tid; i < rows * c4; i += NT) {
      const int r = i / c4, c = (i % c4) * 4;
      cp_async16(smem_u32(dst + r * ldd + c), src + r * lds + c, 16);
    }
  } else {
    for (int i = tid; i < rows * cols; i += NT) {
      const int r = i / cols, c = i % cols;
      cp_async4(smem_u32(dst + r * ldd + c), src + r * lds + c);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_smem(float* smem, int floats, int tid) {
  for (int i = tid * 4; i < floats; i += NT * 4)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// columns col and col + 1 of a row of n floats at p (p points at col)
__device__ __forceinline__ void store_pair(float* p, int col, int n, float v0, float v1) {
  if (col + 1 < n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// the running sum of 64 values, two a lane (lane, lane + 32), in place;
// returns the total
__device__ __forceinline__ float warp_cumsum64(float& v0, float& v1, int lane) {
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
  return __shfl_sync(0xffffffffu, v1, 31);
}

// ------------------------------------------------------------ 1. the dH walk
constexpr int kWalkRows = 32;           // state rows of a walk CTA
constexpr int kWalkWarps = 8;           // warp w owns state columns 16 w..16 w + 15
constexpr int kWalkThreads = kWalkWarps * 32;
constexpr int kWalkStages = 4;          // chunks in shared memory: three in flight

struct WalkLayout {
  static constexpr int kCS = kN + 8;    // C rows: B fragments read (k quad, n grp)
  static constexpr int kDS = kWalkRows + 8;  // dy rows: A fragments read (k quad, m grp)
  static constexpr int c_off = 0;                                  // [kWalkStages][kL][kCS]
  static constexpr int dy_off = c_off + kWalkStages * kL * kCS;    // [kWalkStages][kL][kDS]
  static constexpr int dt_off = dy_off + kWalkStages * kL * kDS;   // [kWalkStages][kL]
  static constexpr int ea_off = dt_off + kWalkStages * kL;         // [kWalkWarps][kL] exp(A)
  static constexpr int floats = ea_off + kWalkWarps * kL;
  static constexpr size_t bytes = sizeof(float) * (size_t)floats;
  static_assert(floats % 4 == 0 && dy_off % 4 == 0 && kCS % 4 == 0 && kDS % 4 == 0,
                "16-byte aligned rows");
  static_assert(bytes <= kSmemLimit, "shared memory");
};

__global__ void __launch_bounds__(kWalkThreads, 1)
ssd_bwd_dh_kernel(const float* __restrict__ dt_a, const float* __restrict__ c_g,
                  const float* __restrict__ dy, const float* __restrict__ dfinal,
                  float* __restrict__ dh_end, int S, int H, int P, int N, int L) {
  using Lay = WalkLayout;
  constexpr int kCS = Lay::kCS, kDS = Lay::kDS, kMT = kWalkRows / 16;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int p0 = blockIdx.x * kWalkRows, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(kWalkRows, P - p0);  // live state rows (P < 32 pads)
  const int nc = S / L, KL = (L + 7) / 8;
  float* const ea = smem + Lay::ea_off + warp * kL;

  // rows past L and columns past N and pw are never copied into: zero
  zero_smem<kWalkThreads>(smem, Lay::floats, tid);
  __syncthreads();

  // chunk ci into ring buffer ci % kWalkStages
  auto load_chunk = [&](int ci) {
    const int buf = ci % kWalkStages;
    const size_t t0 = (size_t)b * S + (size_t)ci * L;
    copy_rows<kWalkThreads>(smem + Lay::c_off + buf * kL * kCS, kCS, c_g + t0 * N, N, L, N,
                            tid);
    copy_rows<kWalkThreads>(smem + Lay::dy_off + buf * kL * kDS, kDS,
                            dy + (t0 * H + h) * P + p0, (size_t)H * P, L, pw, tid);
    copy_rows<kWalkThreads>(smem + Lay::dt_off + buf * kL, 1, dt_a + t0 * H + h, H, L, 1,
                            tid);
  };

  // dH <- d final state: rows 16 mt + grp (+8) of the slice, columns
  // 16 warp + 8 j + 2 quad (+1)
  float dh[kMT][2][4];
  const size_t bh = (size_t)b * H + h;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + grp + 8 * (e >> 1), n = 16 * warp + 8 * j + 2 * quad + (e & 1);
        dh[mt][j][e] = r < pw && n < N ? dfinal[(bh * P + p0 + r) * N + n] : 0.f;
      }
  // the chunks walked last first; chunk 0's data is never needed
#pragma unroll
  for (int i = 0; i < kWalkStages - 1; ++i) {
    if (nc - 1 - i >= 1) load_chunk(nc - 1 - i);
    cp_commit();
  }

  for (int ci = nc - 1;; --ci) {
    float* out = dh_end + ((((size_t)b * nc + ci) * H + h) * P + p0) * N;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + grp + 8 * r, n = 16 * warp + 8 * j + 2 * quad;
          if (row < pw)
            store_pair(out + (size_t)row * N + n, n, N, dh[mt][j][2 * r], dh[mt][j][2 * r + 1]);
        }
    if (ci == 0) break;                 // the adjoint of the zero start is not asked for
    cp_wait<kWalkStages - 2>();         // chunk ci landed
    __syncthreads();                    // and every warp is done with chunk ci + 1's buffer
    if (ci - (kWalkStages - 1) >= 1) load_chunk(ci - (kWalkStages - 1));
    cp_commit();
    const int buf = ci % kWalkStages;
    const float* cs = smem + Lay::c_off + buf * kL * kCS;
    const float* ds = smem + Lay::dy_off + buf * kL * kDS;
    const float* dts = smem + Lay::dt_off + buf * kL;
    // each warp its own A: no barrier between the scan and the product
    float v0 = dts[lane], v1 = dts[lane + 32];
    const float total = warp_cumsum64(v0, v1, lane);   // padding adds 0: A at L - 1
    ea[lane] = expf(v0);
    ea[lane + 32] = expf(v1);
    __syncwarp();
    const float el = expf(total);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dh[mt][j][e] *= el;
    // dH += (exp(A) dy)^T C over the chunk
#pragma unroll 2
    for (int k = 0; k < KL; ++k) {
      const float e0 = ea[8 * k + quad], e1 = ea[8 * k + quad + 4];
      SplitA a[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* d0 = ds + (8 * k + quad) * kDS + 16 * mt + grp;
        a[mt] = split_a(d0[0] * e0, d0[8] * e0, d0[4 * kDS] * e1, d0[4 * kDS + 8] * e1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* cc = cs + (8 * k + quad) * kCS + 16 * warp + 8 * j + grp;
        const SplitB bf = split_b(cc[0], cc[4 * kCS]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma3(dh[mt][j], a[mt], bf);
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ 2. the chunk terms
constexpr int kWarps = 16;              // 0-7 the dH side, 8-15 the H0 side
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;              // ring buffers
constexpr int kGroup = 8;               // most heads a CTA owns

struct ChunkLayout {
  static constexpr int kBS = kN + 4;    // B and C rows: A fragments read (m grp, k quad)
  static constexpr int kHS = kN + 4;    // H0 and dH rows: B fragments read (n grp, k quad)
  static constexpr int kXS = kRows + 4; // x and dy rows
  static constexpr int kWS = kL + 8;    // G, W G and W D rows: A fragments read (k quad, m grp)
  static constexpr int b_off = 0;                          // [kL][kBS]
  static constexpr int c_off = b_off + kL * kBS;           // [kL][kBS]
  static constexpr int g_off = c_off + kL * kBS;           // [kL][kWS] C B^T
  static constexpr int w_off = g_off + kL * kWS;           // [kL][kWS] W G of a head
  static constexpr int wd_off = w_off + kL * kWS;          // [kL][kWS] the group's W D
  static constexpr int d_off = wd_off + kL * kWS;          // [kL][kWS] D = dy x^T of a head
  static constexpr int x_rel = 0;                          // a stage: x [kL][kXS],
  static constexpr int dy_rel = x_rel + kL * kXS;          //   dy [kL][kXS],
  static constexpr int h0_rel = dy_rel + kL * kXS;         //   H0 [kRows][kHS],
  static constexpr int dh_rel = h0_rel + kRows * kHS;      //   dH [kRows][kHS]
  static constexpr int stage = dh_rel + kRows * kHS;
  static constexpr int ring_off = d_off + kL * kWS;        // [kStages][stage]
  static constexpr int a_off = ring_off + kStages * stage; // [kGroup][kL] dt_a, then A
  static constexpr int ea_off = a_off + kGroup * kL;       // [kGroup][kL] exp(A)
  static constexpr int er_off = ea_off + kGroup * kL;      // [kGroup][kL] exp(A_L - A)
  static constexpr int row_off = er_off + kGroup * kL;     // [kLower][16] M's row sums by tile
  static constexpr int col_off = row_off + kLower * 16;    // [kLower][8] its column sums
  static constexpr int so_off = col_off + kLower * 8;      // x.U [2][kL], dy.(H0 C) [8][kL]
  static constexpr int up_off = so_off + 10 * kL;          // [8][32][4] U's second half by pair
  static constexpr int red_off = up_off + 8 * 32 * 4;      // [kWarps] <dH, H0> by warp
  static constexpr int floats = red_off + kWarps;
  static constexpr size_t bytes = sizeof(float) * (size_t)floats;
  static_assert(floats % 4 == 0 && c_off % 4 == 0 && ring_off % 4 == 0 && stage % 4 == 0 &&
                dy_rel % 4 == 0 && h0_rel % 4 == 0 && dh_rel % 4 == 0 && kXS % 4 == 0,
                "16-byte aligned rows");
  static_assert(bytes <= kSmemLimit, "shared memory");
};

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                     const float* __restrict__ b_g, const float* __restrict__ c_g,
                     const float* __restrict__ states, const float* __restrict__ dy,
                     const float* __restrict__ dh_end, float* __restrict__ dx,
                     float* __restrict__ d_dta, float* __restrict__ db_part,
                     float* __restrict__ dc_part, int S, int H, int P, int N, int L,
                     int G) {
  using Lay = ChunkLayout;
  constexpr int kBS = Lay::kBS, kHS = Lay::kHS, kXS = Lay::kXS, kWS = Lay::kWS;
  constexpr int kKS = kRows / 8;        // k-steps over a slice
  extern __shared__ __align__(16) float smem[];
  float* const bs = smem + Lay::b_off;
  float* const cs = smem + Lay::c_off;
  float* const gs = smem + Lay::g_off;
  float* const ws = smem + Lay::w_off;
  float* const wds = smem + Lay::wd_off;
  float* const dds = smem + Lay::d_off;
  float* const as = smem + Lay::a_off;
  float* const eas = smem + Lay::ea_off;
  float* const ers = smem + Lay::er_off;
  float* const rowp = smem + Lay::row_off;
  float* const colp = smem + Lay::col_off;
  float* const sos = smem + Lay::so_off;
  float* const ups = smem + Lay::up_off;
  float* const red = smem + Lay::red_off;

  const int gi = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L, hb = gi * G, ng = min(G, H - hb);
  const int nsl = (P + kRows - 1) / kRows, items = ng * nsl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const bool dh_side = warp < 8;        // dx and dB; else dC and D
  const int wi = warp & 7;              // its 16 columns of dB or dC; warps wi, wi + 8 a pair
  const int ri = wi & 3, half = wi >> 2;  // the pair's 16 x 8 tile of U, and of dx
  const size_t t0 = (size_t)b * S + (size_t)c * L;
  const int KN = (N + 7) / 8, KL = (L + 7) / 8;

  // rows past L, columns past N and P, and H0 of the first chunk stay zero
  zero_smem<kThreads>(smem, Lay::floats, tid);
  __syncthreads();

  // item t of the ring: slice t % nsl of the group's head t / nsl
  auto load_item = [&](int t) {
    const int h = hb + t / nsl, p0 = (t % nsl) * kRows, pw = min(kRows, P - p0);
    float* st = smem + Lay::ring_off + (t % kStages) * Lay::stage;
    copy_rows<kThreads>(st + Lay::x_rel, kXS, x + (t0 * H + h) * P + p0, (size_t)H * P, L,
                        pw, tid);
    copy_rows<kThreads>(st + Lay::dy_rel, kXS, dy + (t0 * H + h) * P + p0, (size_t)H * P, L,
                        pw, tid);
    if (c > 0)
      copy_rows<kThreads>(st + Lay::h0_rel, kHS,
                          states + ((((size_t)b * nc + c - 1) * H + h) * P + p0) * N, N, pw,
                          N, tid);
    copy_rows<kThreads>(st + Lay::dh_rel, kHS,
                        dh_end + ((((size_t)b * nc + c) * H + h) * P + p0) * N, N, pw, N, tid);
  };
  copy_rows<kThreads>(bs, kBS, b_g + t0 * N, N, L, N, tid);
  copy_rows<kThreads>(cs, kBS, c_g + t0 * N, N, L, N, tid);
  for (int i = tid; i < L * ng; i += kThreads) {
    const int l = i / ng, j = i % ng;
    cp_async4(smem_u32(as + j * kL + l), dt_a + (t0 + l) * H + hb + j);
  }
  load_item(0);
  cp_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < items) load_item(t);
    cp_commit();
  }
  cp_wait<kStages - 2>();               // B, C, dt_a and the first item landed
  __syncthreads();

  // A, exp(A) and exp(A_L - A) of head j, by warp j
  if (warp < ng) {
    float* a = as + warp * kL;
    float v0 = a[lane], v1 = a[lane + 32];
    const float total = warp_cumsum64(v0, v1, lane);
    a[lane] = v0;
    a[lane + 32] = v1;
    eas[warp * kL + lane] = expf(v0);
    eas[warp * kL + lane + 32] = expf(v1);
    ers[warp * kL + lane] = expf(total - v0);
    ers[warp * kL + lane + 32] = expf(total - v1);
  }
  // G = C B^T, once for the group, on the tiles on or below the diagonal
  for (int u = warp; u < kLower; u += kWarps) {
    int ti, tj;
    lower_tile(u, ti, tj);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* ca = cs + (16 * ti + grp) * kBS + quad;
    const float* bb = bs + (8 * tj + grp) * kBS + quad;
    for (int k = 0; k < KN; ++k)
      mma3(acc, split_a(ca[8 * k], ca[8 * kBS + 8 * k], ca[8 * k + 4], ca[8 * kBS + 8 * k + 4]),
           split_b(bb[8 * k], bb[8 * k + 4]));
    float* g = gs + (16 * ti + grp) * kWS + 8 * tj + 2 * quad;
    *reinterpret_cast<float2*>(g) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(g + 8 * kWS) = make_float2(acc[2], acc[3]);
  }
  __syncthreads();

  float acc[4][2][4];                   // dB (dH side) or dC: rows 16 mt.., columns 16 wi + 8 nj..
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0.f;

  int t = 0;
  for (int j = 0; j < ng; ++j) {
    const int h = hb + j;
    const float* A = as + j * kL;
    const float* ea = eas + j * kL;
    const float* er = ers + j * kL;
    // W G of this head, and D from zero; every reader of the last head's
    // has passed a barrier
    for (int e = tid; e < kL * kL; e += kThreads) {
      const int l = e / kL, s = e % kL;
      ws[l * kWS + s] = s <= l ? expf(A[l] - A[s]) * gs[l * kWS + s] : 0.f;
      dds[l * kWS + s] = 0.f;
    }
    float so0 = 0.f, so1 = 0.f;         // dH side, rows 16 ri + grp (+8): x.U on this half
    float o[4][2];                      // H0 side, rows 16 mt + grp (+8): dy.(H0 C) on its columns
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) o[mt][0] = o[mt][1] = 0.f;
    float hd = 0.f;                     // <dH, H0>
    for (int q = 0; q < nsl; ++q, ++t) {
      cp_wait<kStages - 2>();           // item t landed
      __syncthreads();                  // and item t - 1's buffer is free
      if (t + kStages - 1 < items) load_item(t + kStages - 1);
      cp_commit();
      const float* st = smem + Lay::ring_off + (t % kStages) * Lay::stage;
      const float* xs = st + Lay::x_rel;
      const float* dys = st + Lay::dy_rel;
      const float* h0s = st + Lay::h0_rel;
      const float* dhs = st + Lay::dh_rel;
      const int p0 = q * kRows;
      for (int e = tid; e < kRows * kN; e += kThreads) {
        const int r = e / kN, n = e % kN;
        hd = fmaf(dhs[r * kHS + n], h0s[r * kHS + n], hd);
      }
      // U = B dH^T on the pair's tile (rows 16 ri.., slice columns 8 half..):
      // the dH side sums the first half of the depth N, the H0 side the
      // second and hands its sum over
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int kh = (KN + 1) / 2;
        const float* ma = bs + (16 * ri + grp) * kBS + quad;
        const float* sb = dhs + (8 * half + grp) * kHS + quad;
#pragma unroll 2
        for (int k = dh_side ? 0 : kh; k < (dh_side ? kh : KN); ++k)
          mma3(u, split_a(ma[8 * k], ma[8 * kBS + 8 * k], ma[8 * k + 4],
                          ma[8 * kBS + 8 * k + 4]),
               split_b(sb[8 * k], sb[8 * k + 4]));
        float* up = ups + (wi * 32 + lane) * 4;
        if (!dh_side) *reinterpret_cast<float4*>(up) = make_float4(u[0], u[1], u[2], u[3]);
        asm volatile("bar.sync %0, 64;\n" :: "r"(1 + wi) : "memory");
        if (dh_side) {
          const float4 v = *reinterpret_cast<const float4*>(up);
          u[0] += v.x;
          u[1] += v.y;
          u[2] += v.z;
          u[3] += v.w;
        }
      }
      if (dh_side) {
        {
          const float* xo = xs + (16 * ri + grp) * kXS + 8 * half + 2 * quad;
          so0 += xo[0] * u[0] + xo[1] * u[1];
          so1 += xo[8 * kXS] * u[2] + xo[8 * kXS + 1] * u[3];
        }
        // dx = (W G)^T dy + exp(A_L - A_s) U: rows s from 16 ri, l >= s
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        const float* wa = ws + quad * kWS + 16 * ri + grp;
        const float* yb = dys + quad * kXS + 8 * half + grp;
        for (int k = 2 * ri; k < KL; ++k)
          mma3(r, split_a(wa[8 * k * kWS], wa[8 * k * kWS + 8], wa[(8 * k + 4) * kWS],
                          wa[(8 * k + 4) * kWS + 8]),
               split_b(yb[8 * k * kXS], yb[(8 * k + 4) * kXS]));
        const int s0 = 16 * ri + grp, s1 = s0 + 8, col = p0 + 8 * half + 2 * quad;
        if (s0 < L)
          store_pair(dx + ((t0 + s0) * H + h) * P + col, col, P, fmaf(er[s0], u[0], r[0]),
                     fmaf(er[s0], u[1], r[1]));
        if (s1 < L)
          store_pair(dx + ((t0 + s1) * H + h) * P + col, col, P, fmaf(er[s1], u[2], r[2]),
                     fmaf(er[s1], u[3], r[3]));
        // dB += diag(exp(A_L - A)) x dH over the slice, this warp's 16 columns
        const float* sb = dhs + quad * kHS + 16 * wi + grp;
#pragma unroll 1
        for (int k = 0; k < kKS; ++k) {
          const SplitB b0 = split_b(sb[8 * k * kHS], sb[(8 * k + 4) * kHS]);
          const SplitB b1 = split_b(sb[8 * k * kHS + 8], sb[(8 * k + 4) * kHS + 8]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const float* aa = xs + (16 * mt + grp) * kXS + 8 * k + quad;
            const SplitA a = split_a(aa[0], aa[8 * kXS], aa[4], aa[8 * kXS + 4]);
            const float r0 = er[16 * mt + grp], r1 = er[16 * mt + grp + 8];
            mma3_rows(acc[mt][0], a, b0, r0, r1);
            mma3_rows(acc[mt][1], a, b1, r0, r1);
          }
        }
      } else {
        // dC += diag(exp(A)) dy H0 over the slice, this warp's 16 columns;
        // each unscaled product dotted with C on its elements gives the
        // dy_l.(H0 C_l) terms of dA (so H0 C is never formed)
        const float* sb = h0s + quad * kHS + 16 * wi + grp;
#pragma unroll 1
        for (int k = 0; k < kKS; ++k) {
          const SplitB b0 = split_b(sb[8 * k * kHS], sb[(8 * k + 4) * kHS]);
          const SplitB b1 = split_b(sb[8 * k * kHS + 8], sb[(8 * k + 4) * kHS + 8]);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const int l0 = 16 * mt + grp;
            const float* aa = dys + l0 * kXS + 8 * k + quad;
            const SplitA a = split_a(aa[0], aa[8 * kXS], aa[4], aa[8 * kXS + 4]);
            const float r0 = ea[l0], r1 = ea[l0 + 8];
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              float big[4], small[4];
              mma3_terms(big, small, a, nj ? b1 : b0);
              const float* cc = cs + l0 * kBS + 16 * wi + 8 * nj + 2 * quad;
              const float2 c0 = *reinterpret_cast<const float2*>(cc);
              const float2 c1 = *reinterpret_cast<const float2*>(cc + 8 * kBS);
              float m[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) m[e] = big[e] + small[e];
              acc[mt][nj][0] = fmaf(r0, m[0], acc[mt][nj][0]);
              acc[mt][nj][1] = fmaf(r0, m[1], acc[mt][nj][1]);
              acc[mt][nj][2] = fmaf(r1, m[2], acc[mt][nj][2]);
              acc[mt][nj][3] = fmaf(r1, m[3], acc[mt][nj][3]);
              o[mt][0] = fmaf(c0.x, m[0], fmaf(c0.y, m[1], o[mt][0]));
              o[mt][1] = fmaf(c1.x, m[2], fmaf(c1.y, m[3], o[mt][1]));
            }
          }
        }
        // D += dy x^T over the slice, on lower tiles wi + 8 r; each element
        // of D in shared memory is this lane's alone
        for (int u = wi; u < kLower; u += 8) {
          int ti, tj;
          lower_tile(u, ti, tj);
          const float* ya = dys + (16 * ti + grp) * kXS + quad;
          const float* xb = xs + (8 * tj + grp) * kXS + quad;
          float* dd = dds + (16 * ti + grp) * kWS + 8 * tj + 2 * quad;
          const float2 lo = *reinterpret_cast<const float2*>(dd);
          const float2 hi = *reinterpret_cast<const float2*>(dd + 8 * kWS);
          float d[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
          for (int k = 0; k < kKS; ++k)
            mma3(d, split_a(ya[8 * k], ya[8 * kXS + 8 * k], ya[8 * k + 4],
                            ya[8 * kXS + 8 * k + 4]),
                 split_b(xb[8 * k], xb[8 * k + 4]));
          *reinterpret_cast<float2*>(dd) = make_float2(d[0], d[1]);
          *reinterpret_cast<float2*>(dd + 8 * kWS) = make_float2(d[2], d[3]);
        }
      }
    }

    // ---- the head's dA terms, each by tile or by warp, then summed in order
    if (!dh_side) {
      // M = W G D: its row and column sums on each tile; the group's W D,
      // each element owned by one lane
      for (int u = wi; u < kLower; u += 8) {
        int ti, tj;
        lower_tile(u, ti, tj);
        const int l0 = 16 * ti + grp, s0 = 8 * tj + 2 * quad;
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (l0 + 8 * (e >> 1)) * kWS + s0 + (e & 1);
          const int l = l0 + 8 * (e >> 1), s = s0 + (e & 1);
          m[e] = ws[i] * dds[i];
          wds[i] = fmaf(s <= l ? expf(A[l] - A[s]) : 0.f, dds[i], wds[i]);
        }
        float r0 = m[0] + m[1], r1 = m[2] + m[3];     // rows l0, l0 + 8
        float c0 = m[0] + m[2], c1 = m[1] + m[3];     // columns s0, s0 + 1
#pragma unroll
        for (int sh = 1; sh < 4; sh <<= 1) {
          r0 += __shfl_xor_sync(0xffffffffu, r0, sh);
          r1 += __shfl_xor_sync(0xffffffffu, r1, sh);
        }
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, sh);
          c1 += __shfl_xor_sync(0xffffffffu, c1, sh);
        }
        if (quad == 0) {
          rowp[u * 16 + grp] = r0;
          rowp[u * 16 + grp + 8] = r1;
        }
        if (grp == 0) {
          colp[u * 8 + 2 * quad] = c0;
          colp[u * 8 + 2 * quad + 1] = c1;
        }
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      so0 += __shfl_xor_sync(0xffffffffu, so0, sh);
      so1 += __shfl_xor_sync(0xffffffffu, so1, sh);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        o[mt][0] += __shfl_xor_sync(0xffffffffu, o[mt][0], sh);
        o[mt][1] += __shfl_xor_sync(0xffffffffu, o[mt][1], sh);
      }
    }
    if (quad == 0) {
      if (dh_side) {                    // x.U: [half][row]
        sos[half * kL + 16 * ri + grp] = so0;
        sos[half * kL + 16 * ri + grp + 8] = so1;
      } else {                          // dy.(H0 C): [2 + wi][row]
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          sos[(2 + wi) * kL + 16 * mt + grp] = o[mt][0];
          sos[(2 + wi) * kL + 16 * mt + grp + 8] = o[mt][1];
        }
      }
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, sh);
    if (lane == 0) red[warp] = hd;
    __syncthreads();
    if (warp == 0) {                    // dA, and its reverse running sum into d dt_a
      float v[2], st[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {     // exp(A_L - A_l) x_l.(dH B_l)
        const int l = lane + 32 * i;
        st[i] = er[l] * (sos[l] + sos[kL + l]);
      }
      float sts = st[0] + st[1];
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sts += __shfl_xor_sync(0xffffffffu, sts, sh);
      float hdot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) hdot += red[w];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int l = lane + 32 * i, ti = l >> 4, tj = l >> 3;
        float row = 0.f, col = 0.f;
        for (int k = 0; k <= 2 * ti + 1; ++k) row += rowp[(ti * (ti + 1) + k) * 16 + (l & 15)];
        for (int k = tj >> 1; k < 4; ++k) col += colp[(k * (k + 1) + tj) * 8 + (l & 7)];
        float dv = 0.f;                 // exp(A_l) dy_l.(H0 C_l), the warps' columns in order
#pragma unroll
        for (int w = 0; w < 8; ++w) dv += sos[(2 + w) * kL + l];
        v[i] = row - col + ea[l] * dv - st[i];
        if (l == L - 1) v[i] += ea[kL - 1] * hdot + sts;
      }
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const float u0 = __shfl_down_sync(0xffffffffu, v[0], sh);
        const float u1 = __shfl_down_sync(0xffffffffu, v[1], sh);
        if (lane + sh < 32) {
          v[0] += u0;
          v[1] += u1;
        }
      }
      v[0] += __shfl_sync(0xffffffffu, v[1], 0);
      if (lane < L) d_dta[(t0 + lane) * H + h] = v[0];
      if (lane + 32 < L) d_dta[(t0 + lane + 32) * H + h] = v[1];
    }
  }

  // ---- the group's intra-chunk terms: dB += (W D)^T C, dC += (W D) B (the
  // last head's barrier made W D visible; above the diagonal it stays zero)
  {
    const float* mb = (dh_side ? cs : bs) + 16 * wi + grp;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int k0 = dh_side ? 2 * mt : 0, k1 = dh_side ? KL : min(2 * mt + 2, KL);
      for (int k = k0; k < k1; ++k) {
        SplitA a;
        if (dh_side) {                  // (W D)^T: rows s, depth l >= s
          const float* wa = wds + (8 * k + quad) * kWS + 16 * mt + grp;
          a = split_a(wa[0], wa[8], wa[4 * kWS], wa[4 * kWS + 8]);
        } else {                        // W D: rows l, depth s <= l
          const float* wa = wds + (16 * mt + grp) * kWS + 8 * k + quad;
          a = split_a(wa[0], wa[8 * kWS], wa[4], wa[8 * kWS + 4]);
        }
        const float* bb = mb + (8 * k + quad) * kBS;
        mma3(acc[mt][0], a, split_b(bb[0], bb[4 * kBS]));
        mma3(acc[mt][1], a, split_b(bb[8], bb[4 * kBS + 8]));
      }
    }
  }
  float* part = (dh_side ? db_part : dc_part) + (((size_t)gi * gridDim.z + b) * S +
                                                  (size_t)c * L) * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * mt + grp + 8 * r, col = 16 * wi + 8 * nj + 2 * quad;
        if (row < L)
          store_pair(part + (size_t)row * N + col, col, N, acc[mt][nj][2 * r],
                     acc[mt][nj][2 * r + 1]);
      }
}

// ------------------------------------------------------------ 3. the groups' sum
// out_k[i] = sum_j part_k[j * m + i] in order of j: dB (k 0) and dC (k 1)
struct SumArgs {
  const float* part[2];
  float* out[2];
  long long m;
  int groups;
};

__global__ void ssd_bwd_sum_kernel(SumArgs args) {
  const float* const part = args.part[blockIdx.y];
  float* const out = args.out[blockIdx.y];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < args.m;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < args.groups; ++j) acc += part[(long long)j * args.m + i];
    out[i] = acc;
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/ssd_scan.py, ssd_bwd_plan) has
// checked the shapes (P in 4, 8, 16, 64; N <= 128; L <= 64 dividing S), made
// every operand contiguous float32 at a 16-byte aligned address, allocated
// dh_end (B,S/L,H,P,N), the partials (ceil(H/G),B,S,N) each and the
// outputs, and picked G (heads a chunk CTA owns, at most 8). The shared
// memory is the layouts' own (WalkLayout, ChunkLayout). Three launches on
// the stream: the walk, the chunk terms, the groups' sum. Returns the first
// failing cudaError_t, else 0.
extern "C" int ssd_scan_bwd(const float* x, const float* dt_a, const float* b,
                            const float* c, const float* states, const float* dy,
                            const float* dfinal, float* dh_end, float* dx, float* d_dta,
                            float* db_part, float* dc_part, float* db, float* dc, int B,
                            int S, int H, int P, int N, int L, int G, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kL || N < 1 || N > kN || P < 4 || P % 4 ||
      (P > kRows && P % kRows) || (P > kWalkRows && P % kWalkRows) || G < 1 || G > kGroup ||
      S < L || S % L)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  static bool walk_allowed = false, chunk_allowed = false;
  int err = allow_smem(ssd_bwd_dh_kernel, WalkLayout::bytes, walk_allowed);
  if (err) return err;
  err = allow_smem(ssd_bwd_chunk_kernel, ChunkLayout::bytes, chunk_allowed);
  if (err) return err;
  ssd_bwd_dh_kernel<<<dim3((P + kWalkRows - 1) / kWalkRows, H, B), kWalkThreads,
                      WalkLayout::bytes, st>>>(dt_a, c, dy, dfinal, dh_end, S, H, P, N, L);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int groups = (H + G - 1) / G;
  ssd_bwd_chunk_kernel<<<dim3(groups, S / L, B), kThreads, ChunkLayout::bytes, st>>>(
      x, dt_a, b, c, states, dy, dh_end, dx, d_dta, db_part, dc_part, S, H, P, N, L, G);
  err = (int)cudaGetLastError();
  if (err) return err;
  SumArgs args;
  args.part[0] = db_part;
  args.part[1] = dc_part;
  args.out[0] = db;
  args.out[1] = dc;
  args.m = (long long)B * S * N;
  args.groups = groups;
  const long long blocks = (args.m + 255) / 256;
  ssd_bwd_sum_kernel<<<dim3((int)(blocks < 1024 ? blocks : 1024), 2), 256, 0, st>>>(args);
  return (int)cudaGetLastError();
}
