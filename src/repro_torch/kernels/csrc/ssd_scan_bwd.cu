// Backward of the Mamba-2 SSD chunk scan, Hopper sm_90a, float32.
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
//   out: dx (B,S,H,P), and per-slice partials of d dt_a (NSL,B,S,H) and of
//        dB, dC (H*NSL,B,S,N), summed by ssd_bwd_sum_kernel (the second
//        launch) into d dt_a, dB, dC.
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
//   dH   <- exp(A_L) dH + sum_l exp(A_l) dy_l C_l^T   (the state entering)
// and d dt_a is the reverse running sum of dA within the chunk. Every
// exponent is at most 0: nothing is rebuilt backwards through exp(-A).
//
// Design. As in the forward, the chunk axis is a loop inside one CTA, here
// walked last chunk first with dH carried in shared memory. A CTA of 256
// threads owns one (batch, head) and PS = 16 or 32 rows of the state (a
// template parameter): one CTA for P <= 16 (rows past P zero), P / 32 CTAs
// for P 64. Every tile is held at L 64, N 128 and PS rows, zero past the
// chunk, the state and the head, so the padding contributes nothing; a
// chunk's B, C, x, dy, H0, dH and the three L x L tiles (W G, W D, M) fill
// about 180 KB of shared memory, one CTA an SM. Each product is a 16 x 16
// thread grid of register tiles (4 x 4 outputs for the L x L tiles, 4 x 8
// for dB and dC), in float32 on the FMA units.
// What bounds it: operations. At mamba2-1.3b's shape (B 1, H 64, P 64, N
// 128, L 64, S 4096) it does about 3.1 M multiply-adds a CTA a chunk where
// the bytes are about 0.1 MB, far above the FMA units' 20 flops a byte; the
// L x L products are computed whole (the causal half is masked after) and
// the C B^T tile is computed again by each P slice of a head. The tensor
// cores (as in the forward's 3xTF32) are the next step.
// B and C are shared by the heads, so their gradients are sums over heads
// and P slices: each CTA writes its own partial rows and a second launch
// sums them in a fixed order (deterministic, no atomics).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;                  // chunk tile
constexpr int kN = 128;                 // state tile
constexpr int kThreads = 256;           // a 16 x 16 grid of register tiles
constexpr int kLdN = kN + 1, kLdL = kL + 1;
constexpr int kSmemLimit = 232448;

template <int PS>
constexpr size_t smem_floats() {
  return 2 * kL * kLdN                  // B, C
         + 4 * kL * (PS + 1)            // x, dy, U = dH B, V = H0 C
         + 2 * PS * kLdN                // H0, dH
         + 3 * kL * kLdL                // W G, W D, M
         + 5 * kL + 32;                 // A, exp(A), exp(A_L - A), dA, S; reduction
}

// acc[i][j] += sum_k A(r_i, k) Bm(c_j, k), r_i = ty + 16 i, c_j = tx + 16 j;
// A(r, k) = A[r * ar + k * ak], Bm(c, k) = Bm[c * bc + k * bk]
template <int TM, int TN>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][TN], const float* A, int ar,
                                        int ak, const float* Bm, int bc, int bk, int K,
                                        int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = A[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bm[(tx + 16 * j) * bc + k * bk];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

template <int PS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ states, const float* __restrict__ dy,
               const float* __restrict__ dfinal, float* __restrict__ dx,
               float* __restrict__ dta_part, float* __restrict__ db_part,
               float* __restrict__ dc_part, int B, int S, int H, int P, int N, int L) {
  constexpr int kLdP = PS + 1;
  constexpr int TP = PS / 16;           // register tile over the state rows
  extern __shared__ float sm[];
  float* const Bs = sm;
  float* const Cs = Bs + kL * kLdN;
  float* const xs = Cs + kL * kLdN;
  float* const dys = xs + kL * kLdP;
  float* const Us = dys + kL * kLdP;
  float* const Vs = Us + kL * kLdP;
  float* const H0s = Vs + kL * kLdP;
  float* const dHs = H0s + PS * kLdN;
  float* const WG = dHs + PS * kLdN;
  float* const WD = WG + kL * kLdL;
  float* const Ms = WD + kL * kLdL;
  float* const Acs = Ms + kL * kLdL;
  float* const eA = Acs + kL;
  float* const eR = eA + kL;
  float* const dAs = eR + kL;
  float* const Ss = dAs + kL;
  float* const red = Ss + kL;

  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsl = gridDim.x, p0 = slice * PS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int nc = S / L;

  // dH <- d final_state
  for (int i = tid; i < PS * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    dHs[p * kLdN + n] = (p0 + p < P && n < N)
        ? dfinal[(((size_t)b * H + h) * P + p0 + p) * N + n] : 0.f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const size_t t0 = (size_t)b * S + (size_t)c * L;     // row of the chunk's first token
    // ---- load the chunk, zero past L, N and P
    for (int i = tid; i < kL * kN; i += kThreads) {
      const int l = i / kN, n = i % kN;
      const bool in = l < L && n < N;
      Bs[l * kLdN + n] = in ? bm[(t0 + l) * N + n] : 0.f;
      Cs[l * kLdN + n] = in ? cm[(t0 + l) * N + n] : 0.f;
    }
    for (int i = tid; i < kL * PS; i += kThreads) {
      const int l = i / PS, p = i % PS;
      const bool in = l < L && p0 + p < P;
      const size_t off = ((t0 + l) * H + h) * P + p0 + p;
      xs[l * kLdP + p] = in ? x[off] : 0.f;
      dys[l * kLdP + p] = in ? dy[off] : 0.f;
    }
    for (int i = tid; i < PS * kN; i += kThreads) {
      const int p = i / kN, n = i % kN;
      H0s[p * kLdN + n] = (c > 0 && p0 + p < P && n < N)
          ? states[((((size_t)b * nc + c - 1) * H + h) * P + p0 + p) * N + n] : 0.f;
    }
    if (tid < kL) Acs[tid] = tid < L ? dt_a[(t0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (warp == 0) {                    // running sum of dt_a: two values a lane
      float v0 = Acs[2 * lane], v1 = v0 + Acs[2 * lane + 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v1, d);
        if (lane >= d) { v0 += u; v1 += u; }
      }
      Acs[2 * lane] = v0;
      Acs[2 * lane + 1] = v1;
    }
    __syncthreads();
    const float a_last = Acs[kL - 1];   // padding adds 0: A at L - 1
    if (tid < kL) {
      eA[tid] = expf(Acs[tid]);
      eR[tid] = expf(a_last - Acs[tid]);
    }
    __syncthreads();

    // ---- W G, W D and M (L x L), U = dH B and V = H0 C (L x PS)
    {
      float g[4][4], d[4][4];
      zero(g);
      zero(d);
      tile_mm(g, Cs, kLdN, 1, Bs, kLdN, 1, kN, ty, tx);
      tile_mm(d, dys, kLdP, 1, xs, kLdP, 1, PS, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = ty + 16 * i, s = tx + 16 * j;
          const float wv = s <= l ? expf(Acs[l] - Acs[s]) : 0.f;
          const float wg = wv * g[i][j];
          WG[l * kLdL + s] = wg;
          WD[l * kLdL + s] = wv * d[i][j];
          Ms[l * kLdL + s] = wg * d[i][j];
        }
      float u[4][TP], v[4][TP];
      zero(u);
      zero(v);
      tile_mm(u, Bs, kLdN, 1, dHs, kLdN, 1, kN, ty, tx);
      tile_mm(v, Cs, kLdN, 1, H0s, kLdN, 1, kN, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          Us[(ty + 16 * i) * kLdP + tx + 16 * j] = u[i][j];
          Vs[(ty + 16 * i) * kLdP + tx + 16 * j] = v[i][j];
        }
    }
    __syncthreads();

    // ---- dx = (W G)^T dy + exp(A_L - A_s) U, written out
    {
      float acc[4][TP];
      zero(acc);
      tile_mm(acc, WG, 1, kLdL, dys, 1, kLdP, kL, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int s = ty + 16 * i, p = tx + 16 * j;
          if (s < L && p0 + p < P)
            dx[((t0 + s) * H + h) * P + p0 + p] =
                acc[i][j] + eR[s] * Us[s * kLdP + p];
        }
    }
    // ---- this slice's dB = (W D)^T C + exp(A_L - A_s) x dH, and
    //      dC = (W D) B + exp(A_l) dy H0
    const size_t part = (((size_t)h * nsl + slice) * B + b) * S + (size_t)c * L;
    {
      float acc[4][8], acc2[4][8];
      zero(acc);
      zero(acc2);
      tile_mm(acc, WD, 1, kLdL, Cs, 1, kLdN, kL, ty, tx);
      tile_mm(acc2, xs, kLdP, 1, dHs, 1, kLdN, PS, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = ty + 16 * i, n = tx + 16 * j;
          if (s < L && n < N)
            db_part[(part + s) * N + n] = acc[i][j] + eR[s] * acc2[i][j];
        }
      zero(acc);
      zero(acc2);
      tile_mm(acc, WD, kLdL, 1, Bs, 1, kLdN, kL, ty, tx);
      tile_mm(acc2, dys, kLdP, 1, H0s, 1, kLdN, PS, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int l = ty + 16 * i, n = tx + 16 * j;
          if (l < L && n < N)
            dc_part[(part + l) * N + n] = acc[i][j] + eA[l] * acc2[i][j];
        }
    }
    // ---- dA: row and column sums of M, the off-chunk and state terms;
    //      and <dH, H0> over the slice
    if (tid < kL) {
      const int l = tid;
      float row = 0.f, col = 0.f, o = 0.f, st = 0.f;
      for (int s = 0; s < kL; ++s) {
        row += Ms[l * kLdL + s];
        col += Ms[s * kLdL + l];
      }
      for (int p = 0; p < PS; ++p) {
        o = fmaf(dys[l * kLdP + p], Vs[l * kLdP + p], o);
        st = fmaf(xs[l * kLdP + p], Us[l * kLdP + p], st);
      }
      st *= eR[l];
      Ss[l] = st;
      dAs[l] = row - col + eA[l] * o - st;
    }
    {
      float dot = 0.f;
      for (int i = tid; i < PS * kN; i += kThreads) {
        const int p = i / kN, n = i % kN;
        dot = fmaf(dHs[p * kLdN + n], H0s[p * kLdN + n], dot);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, d);
      if (lane == 0) red[warp] = dot;
    }
    __syncthreads();
    if (tid == 0) {                     // the last position's terms, then the
      float last = 0.f;                 // reverse running sum into d dt_a
      for (int w = 0; w < kThreads / 32; ++w) last += red[w];
      last *= expf(a_last);
      for (int s = 0; s < kL; ++s) last += Ss[s];
      float run = 0.f;
      for (int l = kL - 1; l >= 0; --l) {
        run += dAs[l] + (l == kL - 1 ? last : 0.f);
        if (l < L) dta_part[(((size_t)slice * B + b) * S + (size_t)c * L + l) * H + h] = run;
      }
    }
    if (c == 0) break;                  // the adjoint of the zero start is not asked for
    // dy scaled by exp(A_l) for the state's adjoint (dy's other readers are done)
    for (int i = tid; i < kL * PS; i += kThreads) {
      const int l = i / PS, p = i % PS;
      dys[l * kLdP + p] *= eA[l];
    }
    __syncthreads();

    // ---- dH <- exp(A_L) dH + (exp(A) dy)^T C: each thread its own outputs
    {
      float acc[TP][8];
      zero(acc);
      tile_mm(acc, dys, 1, kLdP, Cs, 1, kLdN, kL, ty, tx);
      const float e = expf(a_last);
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* const q = dHs + (ty + 16 * i) * kLdN + tx + 16 * j;
          *q = fmaf(e, *q, acc[i][j]);
        }
    }
    __syncthreads();
  }
}

// out_k[i] = sum_j part_k[j * m_k + i], in order of j: the partials of
// d dt_a (k 0), dB (k 1) and dC (k 2), blockIdx.y = k
struct SumArgs {
  const float* part[3];
  float* out[3];
  long long m[3];
  int j[3];
};

__global__ void ssd_bwd_sum_kernel(SumArgs args) {
  const int k = blockIdx.y;
  const float* const part = args.part[k];
  float* const out = args.out[k];
  const long long m = args.m[k];
  const int nj = args.j[k];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < nj; ++j) acc += part[(long long)j * m + i];
    out[i] = acc;
  }
}

template <int PS>
int launch(const float* x, const float* dt_a, const float* bm, const float* cm,
           const float* states, const float* dy, const float* dfinal, float* dx,
           float* dta_part, float* db_part, float* dc_part, int B, int S, int H, int P,
           int N, int L, cudaStream_t st) {
  constexpr int smem = (int)(smem_floats<PS>() * sizeof(float));
  static_assert(smem <= kSmemLimit, "shared memory");
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_kernel<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const int nsl = P > PS ? P / PS : 1;
  const dim3 grid(nsl, H, B);
  ssd_bwd_kernel<PS><<<grid, kThreads, smem, st>>>(
      x, dt_a, bm, cm, states, dy, dfinal, dx, dta_part, db_part, dc_part, B, S, H, P,
      N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/ssd_scan.py) has checked shapes
// (P in 4, 8, 16, 64; N <= 128; L <= 64 dividing S), made every operand
// contiguous float32, and allocated the partials (NSL = P / PS slices, or
// 1: d dt_a (NSL,B,S,H), dB and dC (H*NSL,B,S,N)) and the outputs. Two
// launches: the chunk walk, then the sum of the partials. Returns the first
// failing cudaError_t, else 0.
extern "C" int ssd_scan_bwd(const float* x, const float* dt_a, const float* b,
                            const float* c, const float* states, const float* dy,
                            const float* dfinal, float* dx, float* dta_part,
                            float* db_part, float* dc_part, float* d_dta, float* db,
                            float* dc, int B, int S, int H, int P, int N, int L, int PS,
                            void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kL || N < 1 || N > kN || P < 1 ||
      (PS != 16 && PS != 32) || (P > PS && P % PS) || S < L || S % L)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  const int err = PS == 32
      ? launch<32>(x, dt_a, b, c, states, dy, dfinal, dx, dta_part, db_part, dc_part,
                   B, S, H, P, N, L, st)
      : launch<16>(x, dt_a, b, c, states, dy, dfinal, dx, dta_part, db_part, dc_part,
                   B, S, H, P, N, L, st);
  if (err) return err;
  const int nsl = P > PS ? P / PS : 1;
  SumArgs args;
  const float* parts[3] = {dta_part, db_part, dc_part};
  float* outs[3] = {d_dta, db, dc};
  for (int k = 0; k < 3; ++k) {
    args.part[k] = parts[k];
    args.out[k] = outs[k];
    args.m[k] = (long long)B * S * (k == 0 ? H : N);
    args.j[k] = k == 0 ? nsl : H * nsl;
  }
  const long long most = args.m[0] > args.m[1] ? args.m[0] : args.m[1];
  const int blocks = (int)((most + 255) / 256 < 1024 ? (most + 255) / 256 : 1024);
  ssd_bwd_sum_kernel<<<dim3(blocks, 3), 256, 0, st>>>(args);
  return (int)cudaGetLastError();
}
